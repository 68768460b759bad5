"""The ConcatDiT backbone family (port of ``versband_tpu/models/concat_dit.py``).

Conditioning by temporal concatenation: the sequence fed to the transformer
is ``[t_emb, caption_tokens, x]`` with a learned position embedding, and the
conditioning prefix is sliced off before the final 1x1-conv head. One unit of
depth is a ``TemporalTransformer``: GroupNorm(32) -> 1x1 conv -> {LN ->
self-attention -> LN -> a second self-attention -> LN -> conv-k9 GEGLU FFN,
each residual} -> zero-init 1x1 conv -> residual.

Variants: ``ConcatDiT`` (one caption embedder), ``ConcatDiT2MLP`` (two
caption embedders over the halves of the caption tokens), ``HybridDiT2MLP``
and ``HybridDiT2MLP2`` (codec-token conditioning, channel-concatenated with
the latent; ``cond_fuse`` ``concat_cut`` or ``concat_proj``),
``ConcatOrderDiT`` (per-object order embeddings added to the caption tokens)
and ``ConcatOrderDiT2`` (an order token inserted before each ``|``
separator, the caption stream padded to ``Tc + max_objs``).

Attention is the plain :func:`~versband_tpu_torch.nn.core.sdpa`, as in the
JAX package (no flash kernel on this path). The sequence runs ``[B, T, C]``
as in JAX; the convolutions see it ``[B, C, T]``. Parameter names are the
reference's (``blocks.{i}.transformer_blocks.0.attn1.to_q``,
``ff.net.0.proj``, ``c_embedder.mlp.3``, ``code_proj.0``, ...). LayerNorms
take flax's epsilon, 1e-6. Every model answers ``(out [B, C, T], 0.0)``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from versband_tpu_torch.nn.core import TimestepEmbedder, sdpa

SEP_ID, CLS_ID, EOS_ID, PAD_ID = 1064, 101, 102, 0  # BERT's '|', [CLS], [SEP], [PAD]


def take_fill(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``table[ids]``, NaN where an id is out of range: ``jnp.take``'s
    ``fill`` mode, which flax's ``Embed`` uses (a negative id counts from the
    end); no device assert on the card."""
    n = table.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    ok = (ids >= 0) & (ids < n)
    rows = F.embedding(ids.clamp(0, n - 1), table)
    return torch.where(ok[..., None], rows, torch.full_like(rows, float("nan")))


class PositionEmbedding(nn.Module):
    """Learned absolute positions, added (``weight [num_embeddings, dim]``)."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(num_embeddings, embedding_dim) * 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.weight[None, : x.shape[1]].to(x.dtype)


class CaptionEmbedder(nn.Module):
    """Linear -> GELU (tanh) -> Linear -> LayerNorm, all of it ``mlp`` (the
    concatDiT naming: the norm is ``mlp.3``)."""

    def __init__(self, in_dim: int, hidden_size: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(in_dim, hidden_size), nn.GELU(approximate="tanh"),
                                 nn.Linear(hidden_size, hidden_size),
                                 nn.LayerNorm(hidden_size, eps=1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class CrossAttention(nn.Module):
    """Plain multi-head (self or cross) attention: bias-free q/k/v, biased
    ``to_out.0``; context of ``context_dim`` (default: the query's width)."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        ctx = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        B, T, Tk = x.shape[0], x.shape[1], ctx.shape[1]
        q = self.to_q(x).view(B, T, self.heads, self.dim_head)
        k = self.to_k(ctx).view(B, Tk, self.heads, self.dim_head)
        v = self.to_v(ctx).view(B, Tk, self.heads, self.dim_head)
        return self.to_out(sdpa(q, k, v).reshape(B, T, -1))


class _ConvGEGLU(nn.Module):
    """``proj``: conv to ``2 inner`` channels, then h * gelu(gate) (exact
    GELU), over ``[B, C, T]``."""

    def __init__(self, dim: int, inner: int, kernel_size: int):
        super().__init__()
        self.proj = nn.Conv1d(dim, 2 * inner, kernel_size, padding=kernel_size // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=1)
        return h * F.gelu(gate)


class Conv1dFeedForward(nn.Module):
    """conv-k9 GEGLU FFN (4x wide) over ``[B, T, C]`` (``net.0.proj``,
    ``net.2``); every caller of the JAX module takes its defaults (GLU,
    mult 4, kernel 9)."""

    def __init__(self, dim: int, mult: int = 4, kernel_size: int = 9):
        super().__init__()
        inner = dim * mult
        self.net = nn.Sequential(_ConvGEGLU(dim, inner, kernel_size), nn.Identity(),
                                 nn.Conv1d(inner, dim, kernel_size, padding=kernel_size // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x.transpose(1, 2)).transpose(1, 2)


class BasicTemporalBlock(nn.Module):
    """LN -> self-attention -> LN -> second self-attention -> LN -> conv
    GEGLU FFN, each residual (``attn2`` runs without context)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        dh = dim // heads
        self.attn1 = CrossAttention(dim, None, heads, dh)
        self.attn2 = CrossAttention(dim, None, heads, dh)
        self.ff = Conv1dFeedForward(dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x))
        return x + self.ff(self.norm3(x))


class TemporalTransformer(nn.Module):
    """GroupNorm(32) -> 1x1 conv -> blocks -> zero-init 1x1 conv -> residual,
    over ``[B, T, C]``."""

    def __init__(self, dim: int, heads: int, depth: int = 1):
        super().__init__()
        self.norm = nn.GroupNorm(32, dim, eps=1e-6)
        self.proj_in = nn.Conv1d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList([BasicTemporalBlock(dim, heads)
                                                 for _ in range(depth)])
        self.proj_out = nn.Conv1d(dim, dim, 1)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.proj_in(self.norm(x.transpose(1, 2))).transpose(1, 2)
        for blk in self.transformer_blocks:
            h = blk(h)
        return self.proj_out(h.transpose(1, 2)).transpose(1, 2) + x


class Conv1DFinalLayer(nn.Module):
    """GroupNorm(16) + 1x1 conv head: ``[B, T, C]`` in, ``[B, out, T]`` out."""

    def __init__(self, hidden_size: int, out_channels: int):
        super().__init__()
        self.norm_final = nn.GroupNorm(16, hidden_size, eps=1e-5)
        self.conv1d = nn.Conv1d(hidden_size, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1d(self.norm_final(x.transpose(1, 2)))


def _caption_context(context: Any) -> torch.Tensor:
    if isinstance(context, dict):
        return context.get("c_crossattn", context)
    return context


class _ConcatBase(nn.Module):
    """The shared trunk: temporal concat -> position embedding ->
    TemporalTransformers -> prefix slice -> Conv1DFinalLayer."""

    def __init__(self, in_channels: int, context_dim: int, hidden_size: int = 1152,
                 depth: int = 28, num_heads: int = 16, max_len: int = 1000,
                 final_width: Optional[int] = None):
        super().__init__()
        self.in_channels = in_channels
        self.hidden_size = hidden_size
        self.max_len = max_len
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.pos_emb = PositionEmbedding(max_len, hidden_size)
        self.blocks = nn.ModuleList([TemporalTransformer(hidden_size, num_heads)
                                     for _ in range(depth)])
        self.final_layer = Conv1DFinalLayer(final_width or hidden_size, in_channels)

    def _trunk(self, t: torch.Tensor, c_tok: torch.Tensor, h: torch.Tensor,
               cut_half: bool = False) -> torch.Tensor:
        extra = 1 + c_tok.shape[1]
        h = torch.cat([self.t_embedder(t)[:, None, :].to(h.dtype), c_tok.to(h.dtype), h], dim=1)
        if h.shape[1] > self.max_len:
            raise ValueError(f"sequence of {h.shape[1]} tokens (1 + {c_tok.shape[1]} caption + "
                             f"{h.shape[1] - extra} latent) exceeds max_len {self.max_len}")
        h = self.pos_emb(h)
        for blk in self.blocks:
            h = blk(h)
        h = h[:, extra:]
        if cut_half:  # keep the latent half of the channels
            h = h[:, :, self.hidden_size // 2:]
        return self.final_layer(h)


class ConcatDiT(_ConcatBase):
    """``(x [B, C, T], t [B], context [B, Ty, ctx]) -> (out [B, C, T], 0.0)``."""

    def __init__(self, in_channels: int, context_dim: int, hidden_size: int = 1152,
                 depth: int = 28, num_heads: int = 16, max_len: int = 1000):
        super().__init__(in_channels, context_dim, hidden_size, depth, num_heads, max_len)
        self.proj_in = nn.Conv1d(in_channels, hidden_size, 5, padding=2)
        self.c_embedder = CaptionEmbedder(context_dim, hidden_size)

    def forward(self, x, t, context, step: int = 0, train: bool = False):
        c_tok = self.c_embedder(_caption_context(context))
        h = self.proj_in(x.to(self.proj_in.weight.dtype)).transpose(1, 2)
        return self._trunk(t, c_tok, h), 0.0


class ConcatDiT2MLP(_ConcatBase):
    """Two caption embedders over the two halves of the caption tokens,
    split as ``jnp.array_split`` (the first half takes the odd token)."""

    def __init__(self, in_channels: int, context_dim: int, hidden_size: int = 1152,
                 depth: int = 28, num_heads: int = 16, max_len: int = 1000):
        super().__init__(in_channels, context_dim, hidden_size, depth, num_heads, max_len)
        self.proj_in = nn.Conv1d(in_channels, hidden_size, 5, padding=2)
        self.c1_embedder = CaptionEmbedder(context_dim, hidden_size)
        self.c2_embedder = CaptionEmbedder(context_dim, hidden_size)

    def forward(self, x, t, context, step: int = 0, train: bool = False):
        context = _caption_context(context)
        n = context.shape[1]
        c1, c2 = context.split([(n + 1) // 2, n // 2], dim=1)
        c_tok = torch.cat([self.c1_embedder(c1), self.c2_embedder(c2)], dim=1)
        h = self.proj_in(x.to(self.proj_in.weight.dtype)).transpose(1, 2)
        return self._trunk(t, c_tok, h), 0.0


def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``[n_in, n_out]`` weights of ``jax.image.resize(..., "linear")`` along
    one axis: half-pixel centres, a triangle kernel widened by the inverse
    scale when shrinking (antialiasing), each column normalised by its
    in-range weight, float32."""
    f32 = np.float32
    scale = f32(n_out) / f32(n_in)
    kscale = max(f32(1) / scale, f32(1))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) / scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kscale
    w = np.maximum(f32(0), f32(1) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(total != 0, w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(n_in) - f32(0.5))
    return (w * inside[None, :]).astype(f32)


class HybridDiT2MLP(_ConcatBase):
    """Codec-token conditioned variant. Code ids ``[B, codebooks, T]`` are
    offset per codebook (``id + q * code_num``, clamped at 3072), embedded,
    flattened to one channel stream, projected by ``code_proj`` (conv k5 ->
    LeakyReLU(0.01) -> AvgPool(2)), length-reconciled with the latent and
    channel-concatenated with it. ``concat_cut``: both streams half-width,
    the trunk's output keeps the latent half; ``concat_proj``: both
    full-width and ``fuse_proj`` (Linear 2H -> H). ``HybridDiT2MLP`` always
    runs ``concat_cut``."""

    def __init__(self, in_channels: int, context_dim: int, hidden_size: int = 1152,
                 depth: int = 28, num_heads: int = 16, max_len: int = 1000,
                 code_num: int = 1024, codebook_num: int = 3, unit_upsample_rate: float = 1.0,
                 cond_fuse: str = "concat_cut"):
        half = hidden_size // 2
        if cond_fuse == "concat_cut":
            emb_dim, code_w, lat_w = half // codebook_num, half, half
        elif cond_fuse == "concat_proj":
            emb_dim, code_w, lat_w = hidden_size // codebook_num, hidden_size, hidden_size
        else:
            raise ValueError(f"unknown cond_fuse {cond_fuse!r}")
        super().__init__(in_channels, context_dim, hidden_size, depth, num_heads, max_len,
                         final_width=half if cond_fuse == "concat_cut" else hidden_size)
        self.cond_fuse = cond_fuse
        self.code_num, self.codebook_num = code_num, codebook_num
        self.unit_upsample_rate = unit_upsample_rate
        self.code_embed = nn.Embedding(code_num * codebook_num + 5, emb_dim)
        self.code_proj = nn.Sequential(nn.Conv1d(codebook_num * emb_dim, code_w, 5, padding=2),
                                       nn.LeakyReLU(0.01), nn.AvgPool1d(2))
        self.proj_in = nn.Conv1d(in_channels, lat_w, 5, padding=2)
        if cond_fuse == "concat_proj":
            self.fuse_proj = nn.Linear(2 * hidden_size, hidden_size)
        self.caption_embedder = CaptionEmbedder(context_dim, hidden_size)

    def _embed_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """``[B, Q, T]`` ids -> ``[B, T', code_w]`` projected, pooled features."""
        offsets = self.code_num * torch.arange(self.codebook_num, device=codes.device)
        codes = torch.clamp(codes.long() + offsets[None, :, None], max=3072)
        ce = self.code_embed(codes)  # [B, Q, T, e]
        B, Q, T, e = ce.shape
        ce = ce.transpose(2, 3).reshape(B, Q * e, T)
        if self.unit_upsample_rate != 1.0:
            w = linear_resize_matrix(T, int(T * self.unit_upsample_rate))
            ce = ce @ torch.from_numpy(w).to(ce)
        return self.code_proj(ce).transpose(1, 2)

    @staticmethod
    def _reconcile(acoustic: torch.Tensor, T: int) -> torch.Tensor:
        """Repeat the last frame or cut to ``T`` frames."""
        Ta = acoustic.shape[1]
        if T > Ta:
            return torch.cat([acoustic, acoustic[:, -1:].expand(-1, T - Ta, -1)], dim=1)
        return acoustic[:, :T]

    def forward(self, x, t, context, step: int = 0, train: bool = False):
        codes = None
        if isinstance(context, dict):
            codes = context.get("c_concat")
            if isinstance(codes, dict):
                codes = codes.get("acoustic")
            context = context.get("c_crossattn", context)
        h = self.proj_in(x.to(self.proj_in.weight.dtype)).transpose(1, 2)  # [B, T, lat_w]
        acoustic = self._reconcile(self._embed_codes(codes), h.shape[1])
        h = torch.cat([acoustic.to(h.dtype), h], dim=2)
        if self.cond_fuse == "concat_proj":
            h = self.fuse_proj(h)
        c_tok = self.caption_embedder(context)
        return self._trunk(t, c_tok, h, cut_half=self.cond_fuse == "concat_cut"), 0.0


class HybridDiT2MLP2(HybridDiT2MLP):
    """``HybridDiT2MLP`` with ``cond_fuse`` selectable (``concat_cut`` or
    ``concat_proj``)."""


def order_index_per_token(token_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(obj_index [B, Tc], is_special [B, Tc]): the number of ``|``
    separators (BERT id 1064) before each token, and whether it is one of the
    tokens that take no order embedding (``[CLS]`` 101, ``[SEP]`` 102,
    ``[PAD]`` 0, ``|``)."""
    is_sep = token_ids == SEP_ID
    special = is_sep | (token_ids == CLS_ID) | (token_ids == EOS_ID) | (token_ids == PAD_ID)
    sep = is_sep.long()
    return torch.cumsum(sep, dim=1) - sep, special


def _order_context(context: Any):
    return (context["token_embedding"], context["token_ids"].long(),
            context["orders"].long())


class ConcatOrderDiT(_ConcatBase):
    """Order-conditioned ConcatDiT: object k's caption tokens (segmented by
    the ``|`` separators) get ``order_embedding(orders[k])`` added.
    Context: ``{'token_embedding': [B, Tc, ctx], 'token_ids': [B, Tc],
    'orders': [B, max_objs]}`` (padded int orders)."""

    def __init__(self, in_channels: int, context_dim: int, hidden_size: int = 1152,
                 depth: int = 28, num_heads: int = 16, max_len: int = 1000,
                 num_orders: int = 100):
        super().__init__(in_channels, context_dim, hidden_size, depth, num_heads, max_len)
        self.c_embedder = CaptionEmbedder(context_dim, hidden_size)
        self.order_embedding = nn.Embedding(num_orders, hidden_size)
        self.proj_in = nn.Conv1d(in_channels, hidden_size, 5, padding=2)

    def forward(self, x, t, context, step: int = 0, train: bool = False):
        emb, ids, orders = _order_context(context)
        c = self.c_embedder(emb)
        order_emb = take_fill(self.order_embedding.weight, orders)  # [B, max_objs, H]
        obj_idx, special = order_index_per_token(ids)
        obj_idx = obj_idx.clamp(max=orders.shape[1] - 1)
        per_token = torch.gather(order_emb, 1, obj_idx[..., None].expand(-1, -1, c.shape[-1]))
        c = c + torch.where(special[..., None], torch.zeros_like(per_token), per_token)
        h = self.proj_in(x.to(self.proj_in.weight.dtype)).transpose(1, 2)
        return self._trunk(t, c, h), 0.0


class ConcatOrderDiT2(_ConcatBase):
    """Order-token variant: an order token is inserted immediately before
    each ``|`` separator and the caption stream is padded with the pad-order
    embedding (id ``max_objs_order``) to ``Tc + max_objs`` tokens. Built by a
    fixed-shape scatter into a buffer with one trash slot, which takes the
    writes that fall off the end: token j lands at ``j + #separators <= j``,
    order token k at ``sep_pos_k + k``."""

    def __init__(self, in_channels: int, context_dim: int, hidden_size: int = 1152,
                 depth: int = 28, num_heads: int = 16, max_len: int = 1000,
                 max_objs: int = 10, max_objs_order: int = 100):
        super().__init__(in_channels, context_dim, hidden_size, depth, num_heads, max_len)
        self.max_objs, self.max_objs_order = max_objs, max_objs_order
        self.c_embedder = CaptionEmbedder(context_dim, hidden_size)
        self.order_embedding = nn.Embedding(max_objs_order + 1, hidden_size)
        self.proj_in = nn.Conv1d(in_channels, hidden_size, 5, padding=2)

    def caption_tokens(self, context) -> torch.Tensor:
        """The caption stream ``[B, Tc + max_objs, H]`` with the order tokens in."""
        emb, ids, orders = _order_context(context)
        c = self.c_embedder(emb)
        B, Tc, H = c.shape
        table = self.order_embedding.weight.to(c.dtype)
        order_emb = take_fill(table, orders.clamp(max=self.max_objs_order))
        is_sep = ids == SEP_ID
        sep_incl = torch.cumsum(is_sep.long(), dim=1)
        tok_pos = torch.arange(Tc, device=c.device)[None, :] + sep_incl
        sep_excl = sep_incl - is_sep.long()
        out_len = Tc + self.max_objs
        buf = torch.cat([table[self.max_objs_order].expand(B, out_len, H),
                         c.new_zeros(B, 1, H)], dim=1).clone()
        batch = torch.arange(B, device=c.device)[:, None].expand(B, Tc)
        buf[batch, torch.where(tok_pos < out_len, tok_pos, out_len)] = c
        ord_tok = torch.gather(order_emb, 1, sep_excl.clamp(max=self.max_objs - 1)[..., None]
                               .expand(-1, -1, H))
        ord_dst = torch.where(is_sep & (tok_pos - 1 < out_len), tok_pos - 1,
                              torch.full_like(tok_pos, out_len))
        buf[batch, ord_dst] = ord_tok
        return buf[:, :out_len]

    def forward(self, x, t, context, step: int = 0, train: bool = False):
        c = self.caption_tokens(context)
        h = self.proj_in(x.to(self.proj_in.weight.dtype)).transpose(1, 2)
        return self._trunk(t, c, h), 0.0
