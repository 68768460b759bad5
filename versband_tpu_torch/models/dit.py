"""Band-MoE flow-matching DiT backbone (port of ``versband_tpu/models/dit.py``).

Depth-4, hidden-768 transformer over VAE latents: adaLN-zero conditioning on
timestep + pooled caption, RoPE self-attention (kernel K1 when ``use_flash``)
with a tanh-gated text cross path, and the Band-MoE FFN (caption
cross-attention, a 2-way group gate on the timestep embedding, per-token
Gumbel gates over 4 SwiGLU experts per group, and frequency-band experts over
hidden-channel partitions, with the usage*log(usage) load-balancing loss).

Parameter names are the reference checkpoint's (``layers.{i}.attention.wq``,
``feed_forward.caption_experts.{e}.w1``, ``feed_forward.cross_attention.in_proj_weight``,
...). Experts are evaluated densely and mixed by their gates, as the JAX
package does at 4 experts. ``moe_eval_routed`` selects, at eval only, the
routed path (JAX's ``ragged_dot`` one, off by default there too): each
token runs only its argmax expert, the tokens sorted by expert and each
expert's segment one ``torch.matmul`` per projection. In bf16 every expert
keeps its products in float32 (``jnp.einsum``'s ``preferred_element_type``)
and the gates' probabilities are float32 where JAX divides by its float32
temperature, so the mixed output stays float32 up to the frequency
experts; ``nn/rounding.py`` says where the rest rounds.

Training routing (``train=True``) is soft. Its Gumbel noise comes from the
``gumbel`` argument of :meth:`BandMoeDiT.forward`: a ``torch.Generator`` to
draw from, or an iterator of noise tensors handed in, consumed per block in
the JAX order (high-level gate ``[B, 2]``, caption gate ``[B, T, E]``,
acoustic gate ``[B, T, E]``). Without it, training routing is soft with no
noise, as in JAX without a ``gumbel`` rng. The noise of a block is drawn
before the block runs, so ``remat`` (``torch.utils.checkpoint`` per block)
recomputes the block with the same noise. In a training forward under a
process group the load-balancing loss takes each expert's usage over the
global batch (``parallel.global_sum`` of its numerator and denominator,
over the data group).

Under tensor and expert parallelism (``parallel.sharding.shard_module_``)
each rank of a model group holds half or a quarter of every attention's
heads and of each expert group. The gates stay whole on every rank and see
the same inputs, so the ranks route alike; each rank mixes its own experts
by its columns of the gate probabilities, and the partial sums meet in one
``reduce_from_model`` per expert stage (for the frequency experts, each
rank's bands written into zeros: an all-gather made of one all-reduce).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from versband_tpu_torch.nn.core import (
    ConditionEmbedder, FeedForward, JointAttention, RMSNorm, TimestepEmbedder,
    modulate, precompute_rope, sdpa,
)
from versband_tpu_torch.nn.rounding import (
    Conv1d, LayerNorm, LeakyReLU, Linear, SiLU, layer_norm, linear, linear_f32, softmax,
)
from versband_tpu_torch.parallel import copy_to_model, global_sum, reduce_from_model


def anneal_temperature(step: int, init: float = 2.0, decay: float = 0.9999,
                       floor: float = 0.3) -> float:
    """tau(step) = max(floor, init * decay^step), computed in float32 as the
    reference does. A Python number, so the forward never copies a host
    scalar to the card."""
    f32 = np.float32
    return float(max(f32(floor), f32(init) * f32(decay) ** f32(step)))


def anneal_loss_weight(step: int, decay: float = 0.9999, floor: float = 0.01) -> float:
    return float(max(np.float32(floor), np.float32(decay) ** np.float32(step)))


GumbelSource = Union[torch.Generator, Iterator[torch.Tensor]]


def draw_gumbel(source: GumbelSource, shape: Tuple[int, ...], like: torch.Tensor
                ) -> torch.Tensor:
    """Standard Gumbel noise of ``shape``: drawn from a generator as
    ``-log(-log(u))``, u uniform in [tiny, 1), or the next tensor handed in."""
    if isinstance(source, torch.Generator):
        u = torch.rand(shape, generator=source, device=source.device)
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    else:
        g = next(source)
        if tuple(g.shape) != tuple(shape):
            raise ValueError(f"Gumbel noise of shape {tuple(g.shape)}, expected {shape}")
    return g.to(device=like.device, dtype=like.dtype)


def gumbel_softmax(logits: torch.Tensor, temperature: float, hard: bool,
                   noise: Optional[torch.Tensor] = None, fp32: bool = False) -> torch.Tensor:
    """Gumbel-softmax, straight-through when ``hard``. Without ``noise`` it is
    the deterministic limit (the sampler's routing): soft -> softmax, hard ->
    one-hot argmax. ``fp32``: divide by the temperature in float32, as JAX
    does with its annealed temperature (a float32 array, which promotes
    low-precision logits)."""
    y = logits if noise is None else logits + noise
    y_soft = softmax((y.float() if fp32 else y) / temperature, dim=-1)
    if hard:
        idx = y_soft.argmax(dim=-1)
        y_hard = F.one_hot(idx, logits.shape[-1]).to(y_soft.dtype)
        return y_hard - y_soft.detach() + y_soft
    return y_soft


class StackedSwiGLU(nn.ModuleList):
    """E SwiGLU experts (``{e}.w1/w2/w3``), evaluated densely or band-diagonally.

    Under expert parallelism the other ranks' experts are None here (their
    names, and so the others', stay the one-process names); each method
    then computes this rank's experts only, which the caller sums over the
    model group."""

    def __init__(self, num_experts: int, dim: int, hidden_dim: int, multiple_of: int = 256):
        super().__init__([FeedForward(dim, hidden_dim, multiple_of)
                          for _ in range(num_experts)])

    def local(self) -> List[int]:
        """The indices of the experts this rank holds."""
        return [e for e, expert in enumerate(self) if expert is not None]

    def _expert(self, e: int, x: torch.Tensor, band: slice = slice(None)) -> torch.Tensor:
        """Expert e on ``x`` (its input channels and outputs cut to ``band``) as
        JAX's ``StackedSwiGLU`` computes it: w1 and w3 products kept in float32,
        ``silu(a) * b`` rounded once to the weights' type, the w2 product in
        float32."""
        ex = self[e]
        w1, w3, w2 = ex.w1.weight[:, band], ex.w3.weight[:, band], ex.w2.weight[band]
        inner = F.silu(linear_f32(x, w1)) * linear_f32(x, w3)
        return linear_f32(inner.to(w1.dtype), w2)

    def _dtype(self) -> torch.dtype:
        return self[self.local()[0]].w1.weight.dtype

    def dense(self, x: torch.Tensor) -> torch.Tensor:
        """Every expert on the shared input ``[B, T, d]``, or expert e on its
        own input ``x[e]`` of ``[E, B, T, d]`` -> ``[E, B, T, d]`` in the
        weights' type (E: the experts this rank holds)."""
        own = self.local()
        if x.ndim == 4:
            if x.shape[0] != len(own):
                raise ValueError(f"{x.shape[0]} expert inputs for {len(own)} experts")
            outs = [self._expert(e, xe) for e, xe in zip(own, x)]
        else:
            outs = [self._expert(e, x) for e in own]
        return torch.stack(outs).to(self._dtype())

    def routed(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Token ``(b, t)`` through expert ``idx[b, t]`` only -> ``[B, T, d]``
        (zero where that expert is another rank's).

        The tokens are sorted by expert (a stable argsort, ``jnp.argsort``'s
        order), counted per expert (read on the host: the segments' sizes
        slice the products), run segment by segment through the expert, and
        put back in their places."""
        B, T, d = x.shape
        xf, idf = x.reshape(B * T, d), idx.reshape(B * T)
        order = torch.argsort(idf, stable=True)
        counts = torch.bincount(idf, minlength=len(self)).tolist()
        whole = len(self.local()) == len(self)
        out = (xf.new_empty if whole else xf.new_zeros)(xf.shape, dtype=self._dtype())
        start = 0
        for e, n in enumerate(counts):
            if self[e] is not None:
                out[start: start + n] = self._expert(e, xf[order[start: start + n]])
            start += n
        return out[torch.argsort(order)].reshape(B, T, d)

    def band_diagonal(self, x: torch.Tensor) -> torch.Tensor:
        """Expert e on channel band e only, its band-e outputs kept -> ``[B, T, d]``
        in the weights' type (zero on the bands of another rank's experts).

        Equals running expert e on x masked to band e and keeping band e of its
        output, with the matmuls contracted over the band alone.
        """
        band = x.shape[-1] // len(self)
        own = self.local()
        outs = [self._expert(e, x[..., e * band:(e + 1) * band], slice(e * band, (e + 1) * band))
                for e in own]
        dtype = self._dtype()
        if len(outs) == len(self):
            return torch.cat(outs, dim=-1).to(dtype)
        out = x.new_zeros(x.shape, dtype=dtype)
        for e, o in zip(own, outs):
            out[..., e * band:(e + 1) * band] = o
        return out


class CaptionCrossAttention(nn.Module):
    """Biased multi-head attention (q = x, kv = caption) with
    ``nn.MultiheadAttention``'s parameter names; plain :func:`sdpa` inside.

    Cut by ``parallel.sharding.shard_module_`` (``tp_group`` set), it holds
    the q, k and v rows of ``n_local`` heads and their columns of
    ``out_proj``; the whole ``in_proj_bias`` is sliced at use, and
    ``out_proj.bias`` is added once, after the partial products are summed."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.tp_group = None
        self.n_local, self.head_offset = num_heads, 0

    def forward(self, x: torch.Tensor, caption: torch.Tensor) -> torch.Tensor:
        B, T, d = x.shape
        hd = d // self.num_heads
        group, H = self.tp_group, self.n_local
        wq, wk, wv = self.in_proj_weight.chunk(3)
        if group is None:
            bq, bk, bv = self.in_proj_bias.chunk(3)
        else:
            x, caption = copy_to_model(x, group), copy_to_model(caption, group)
            cols = slice(self.head_offset * hd, (self.head_offset + H) * hd)
            bq, bk, bv = (b[cols] for b in copy_to_model(self.in_proj_bias, group).chunk(3))
        q = linear(x, wq, bq).view(B, T, H, hd)
        k = linear(caption, wk, bk).view(B, caption.shape[1], H, hd)
        v = linear(caption, wv, bv).view(B, caption.shape[1], H, hd)
        out = sdpa(q, k, v).reshape(B, T, H * hd)
        if group is None:
            return self.out_proj(out)
        return reduce_from_model(F.linear(out, self.out_proj.weight), group) + self.out_proj.bias


class BandMoE(nn.Module):
    """The Band-MoE FFN block; ``forward`` returns (output, load_balance_loss)."""

    def __init__(self, dim: int, hidden_dim: int, num_experts: int = 4,
                 multiple_of: int = 256, temperature_init: float = 2.0,
                 eval_routed: bool = False):
        super().__init__()
        self.num_experts = num_experts
        self.eval_routed = eval_routed
        self.temperature_init = temperature_init
        self.cross_attention = CaptionCrossAttention(dim)
        self.high_level_gating_network = Linear(dim, 2)
        self.caption_gating_network = Linear(dim, num_experts)
        self.acoustic_gating_network = Linear(dim, num_experts)
        for lin in (self.high_level_gating_network, self.caption_gating_network,
                    self.acoustic_gating_network):
            nn.init.xavier_uniform_(lin.weight)
            nn.init.zeros_(lin.bias)
        self.caption_experts = StackedSwiGLU(num_experts, dim, hidden_dim, multiple_of)
        self.acoustic_experts = StackedSwiGLU(num_experts, dim, hidden_dim, multiple_of)
        self.freq_experts = StackedSwiGLU(num_experts, dim, hidden_dim, multiple_of)
        # set by parallel.sharding.shard_module_: the model group that shares
        # the experts (None: every expert here) and the data group the
        # load-balancing usage sums over (None: the whole process group)
        self.tp_group = None
        self.data_group = None

    def noise_shapes(self, B: int, T: int) -> List[Tuple[int, ...]]:
        """Shapes of the Gumbel noise one training forward draws, in order."""
        return [(B, 2), (B, T, self.num_experts), (B, T, self.num_experts)]

    def _mix(self, x, cap_feat, acoustic, cap_probs, ac_probs, hl_probs, hard: bool
             ) -> torch.Tensor:
        """The caption and acoustic experts this rank holds, mixed by their
        columns of the gate probabilities and the group gate (each token
        through its argmax expert alone on the routed eval path)."""
        cap_mask = hl_probs[:, 0][:, None, None]
        ac_mask = hl_probs[:, 1][:, None, None]
        if hard and self.eval_routed:
            cap_idx = self.caption_gating_network(cap_feat).argmax(dim=-1)
            ac_idx = self.acoustic_gating_network(acoustic).argmax(dim=-1)
            return (self.caption_experts.routed(x, cap_idx) * cap_mask
                    + self.acoustic_experts.routed(x, ac_idx) * ac_mask)
        # JAX's einsum promotes the experts' outputs to the probabilities' type
        cap = self.caption_experts.dense(x).to(cap_probs.dtype)
        ac = self.acoustic_experts.dense(x).to(ac_probs.dtype)
        return (torch.einsum("ebtd,bte->btd", cap, cap_probs) * cap_mask
                + torch.einsum("ebtd,bte->btd", ac, ac_probs) * ac_mask)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor, caption: torch.Tensor,
                acoustic: torch.Tensor, step: int = 0, train: bool = False,
                noise: Optional[List[torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``noise``: the (high-level, caption, acoustic) Gumbel draws of a
        training forward, or None for no noise."""
        B, T, _ = x.shape
        E = self.num_experts
        temperature = anneal_temperature(step, self.temperature_init)
        hard = not train
        hl_g, cap_g, ac_g = noise if (train and noise is not None) else (None, None, None)

        cap_feat = self.cross_attention(x, caption)
        hl_probs = gumbel_softmax(self.high_level_gating_network(t_emb), 1.0, False, hl_g)
        cap_mask = hl_probs[:, 0][:, None, None]
        ac_mask = hl_probs[:, 1][:, None, None]

        cap_probs = gumbel_softmax(self.caption_gating_network(cap_feat), temperature, hard,
                                   cap_g, fp32=True)
        ac_probs = gumbel_softmax(self.acoustic_gating_network(acoustic), temperature, hard,
                                  ac_g, fp32=True)

        group = self.tp_group
        if group is None:
            mixed = self._mix(x, cap_feat, acoustic, cap_probs, ac_probs, hl_probs, hard)
            z = self.freq_experts.band_diagonal(mixed)
        else:
            # the gates' outputs are whole on every rank: each rank's slice of
            # the work takes them through copy_to_model, so their gradients
            # come back as the sum of the ranks' parts
            xm, hl_m = copy_to_model(x, group), copy_to_model(hl_probs, group)
            own_c, own_a = self.caption_experts.local(), self.acoustic_experts.local()
            cp = copy_to_model(cap_probs, group)[..., own_c]
            ap = copy_to_model(ac_probs, group)[..., own_a]
            mixed = reduce_from_model(self._mix(xm, cap_feat, acoustic, cp, ap, hl_m, hard),
                                      group)
            z = reduce_from_model(
                self.freq_experts.band_diagonal(copy_to_model(mixed, group)), group)

        cap_m = cap_mask.expand(B, T, 1).reshape(-1, 1)
        ac_m = ac_mask.expand(B, T, 1).reshape(-1, 1)
        probs_all = torch.cat([cap_probs.reshape(-1, E), ac_probs.reshape(-1, E)], dim=1)
        masks_all = torch.cat([cap_m.expand(-1, E), ac_m.expand(-1, E)], dim=1)
        num, den = (probs_all * masks_all).sum(0), masks_all.sum()
        if train and torch.is_grad_enabled():
            # usage over the global batch, as JAX's global program takes it:
            # the loss is not linear in the batch, so a per-rank usage would
            # give another gradient than the full batch's
            num, den = global_sum(torch.cat([num, den[None]]), self.data_group).split([2 * E, 1])
            den = den[0]
        usage = num / (den + 1e-10)
        lb_loss = torch.mean(usage * torch.log(usage + 1e-10))
        return z, lb_loss


class FinalLayer(nn.Module):
    """adaLN-zero final projection."""

    def __init__(self, hidden_size: int, out_channels: int):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(SiLU(), Linear(hidden_size, 2 * hidden_size))
        self.linear = Linear(hidden_size, out_channels)
        for lin in (self.adaLN_modulation[1], self.linear):
            nn.init.zeros_(lin.weight)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        x = layer_norm(x, x.shape[-1:], eps=1e-6)
        return self.linear(modulate(x, shift, scale))


class TransformerBlock(nn.Module):
    """adaLN (6-way) -> gated joint attention -> Band-MoE FFN; returns (h, lb_loss)."""

    def __init__(self, dim: int, n_heads: int, y_dim: int, num_experts: int = 4,
                 n_kv_heads: Optional[int] = None, multiple_of: int = 256,
                 norm_eps: float = 1e-5, qk_norm: bool = False, use_flash: bool = False,
                 moe_eval_routed: bool = False):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(SiLU(), Linear(dim, 6 * dim))
        nn.init.zeros_(self.adaLN_modulation[1].weight)
        nn.init.zeros_(self.adaLN_modulation[1].bias)
        self.attention_norm = RMSNorm(dim, norm_eps)
        self.attention_y_norm = RMSNorm(y_dim, norm_eps)
        self.ffn_norm = RMSNorm(dim, norm_eps)
        self.attention = JointAttention(dim, n_heads, n_kv_heads, qk_norm, y_dim,
                                        use_flash=use_flash)
        self.feed_forward = BandMoE(dim, dim, num_experts, multiple_of,
                                    eval_routed=moe_eval_routed)

    def forward(self, x, x_mask, y, y_mask, rope_cos, rope_sin, adaln_input,
                t_emb, caption, acoustic, step: int = 0, train: bool = False, noise=None):
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = self.adaLN_modulation(adaln_input).chunk(6, dim=-1)
        attn_in = modulate(self.attention_norm(x), shift_msa, scale_msa)
        h = x + gate_msa[:, None, :] * self.attention(
            attn_in, x_mask, rope_cos, rope_sin, self.attention_y_norm(y), y_mask)
        ffn_in = modulate(self.ffn_norm(h), shift_mlp, scale_mlp)
        out, lb = self.feed_forward(ffn_in, t_emb, caption, acoustic, step=step, train=train,
                                    noise=noise)
        return h + gate_mlp[:, None, :] * out, lb


class ConvLeakyPool(nn.Sequential):
    """conv(k5) -> LeakyReLU(0.01) -> AvgPool1d(2) over ``[B, C, T]`` (key ``0`` is the conv)."""

    def __init__(self, hidden_size: int, kernel_size: int = 5, pool: int = 2):
        super().__init__(Conv1d(hidden_size, hidden_size, kernel_size, padding=kernel_size // 2),
                         LeakyReLU(0.01), nn.AvgPool1d(pool))


class BandMoeDiT(nn.Module):
    """The shipped vocal2music backbone (``configs/vocal2music.yaml``).

    ``forward(x [B,C,T_lat], t [B], context) -> (v [B,C,T_lat], lb_loss)`` with
    ``context = {'c_concat': {'midi': [B,1,T], 'beats': [B,1,T]},
    'c_crossattn': caption [B,Ty,ori_dim]}``; midi/beats are frame ids at mel
    rate, embedded, conv-projected and 2x pooled to the latent rate.
    ``{"encode_only": True}`` returns the t-independent encodings, which a
    sampler feeds back as ``{"c_encoded": ...}`` on every step.
    ``remat`` recomputes each block in the backward (``torch.utils.checkpoint``)
    instead of keeping its activations.
    """

    def __init__(self, in_channels: int, context_dim: int = 768, hidden_size: int = 768,
                 depth: int = 4, num_heads: int = 8, max_len: int = 1500,
                 num_experts: int = 4, ori_dim: int = 1024,
                 n_kv_heads: Optional[int] = None, multiple_of: int = 256,
                 norm_eps: float = 1e-5, qk_norm: bool = False,
                 rope_scaling_factor: float = 1.0, ntk_factor: float = 1.0,
                 midi_vocab: int = 130, beats_vocab: int = 3, use_flash: bool = False,
                 moe_eval_routed: bool = False, remat: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.remat = remat
        self.depth = depth
        self.head_dim = hidden_size // num_heads
        self.max_len = max_len
        self.rope_scaling_factor = rope_scaling_factor
        self.ntk_factor = ntk_factor
        self._rope: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

        self.midi_embedding = nn.Embedding(midi_vocab, hidden_size)
        self.beats_embedding = nn.Embedding(beats_vocab, hidden_size)
        self.midi_proj = ConvLeakyPool(hidden_size)
        self.beats_proj = ConvLeakyPool(hidden_size)
        self.final_proj = Conv1d(hidden_size, hidden_size, 1)
        self.c_embedder = ConditionEmbedder(ori_dim, hidden_size)
        self.cap_embedder = nn.Sequential(LayerNorm(hidden_size, eps=1e-6),
                                          Linear(hidden_size, hidden_size))
        nn.init.xavier_uniform_(self.cap_embedder[1].weight)
        self.proj_in = Conv1d(in_channels, hidden_size, 5, padding=2)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.layers = nn.ModuleList([
            TransformerBlock(hidden_size, num_heads, hidden_size, num_experts=num_experts,
                             n_kv_heads=n_kv_heads, multiple_of=multiple_of,
                             norm_eps=norm_eps, qk_norm=qk_norm, use_flash=use_flash,
                         moe_eval_routed=moe_eval_routed)
            for _ in range(depth)])
        self.final_layer = FinalLayer(hidden_size, in_channels)

    def rope_tables(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 RoPE tables on ``device``, made once per device (kept out of the
        module's buffers so a cast of the model to bf16 leaves them fp32)."""
        if device not in self._rope:
            cos, sin = precompute_rope(self.head_dim, self.max_len,
                                       rope_scaling_factor=self.rope_scaling_factor,
                                       ntk_factor=self.ntk_factor)
            self._rope[device] = (torch.from_numpy(cos).to(device),
                                  torch.from_numpy(sin).to(device))
        return self._rope[device]

    def encode(self, context: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The t- and x-independent conditioning: acoustic, caption, cap_emb."""
        dtype = self.proj_in.weight.dtype
        midi = context["c_concat"]["midi"]
        beats = context["c_concat"]["beats"]
        if midi.ndim == 3:
            midi = midi[:, 0, :]
        if beats.ndim == 3:
            beats = beats[:, 0, :]
        midi_e = self.midi_proj(self.midi_embedding(midi.long()).transpose(1, 2))
        beats_e = self.beats_proj(self.beats_embedding(beats.long()).transpose(1, 2))
        acoustic = self.final_proj(midi_e + beats_e).transpose(1, 2)  # [B, T_mel/2, H]
        caption = self.c_embedder(context["c_crossattn"].to(dtype))  # [B, Ty, H]
        cap_emb = self.cap_embedder(caption.mean(dim=1))
        return {"acoustic": acoustic, "caption": caption, "cap_emb": cap_emb}

    def gumbel_shapes(self, B: int, T: int) -> List[Tuple[int, ...]]:
        """Shapes of all Gumbel noise a training forward of latent length T draws."""
        return [s for blk in self.layers for s in blk.feed_forward.noise_shapes(B, T)]

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: Dict[str, Any],
                step: int = 0, train: bool = False, gumbel: Optional[GumbelSource] = None):
        encoded = context.get("c_encoded")
        if encoded is None:
            encoded = self.encode(context)
        if context.get("encode_only"):
            return encoded
        acoustic, caption, cap_emb = encoded["acoustic"], encoded["caption"], encoded["cap_emb"]

        dtype = self.proj_in.weight.dtype
        rope_cos, rope_sin = self.rope_tables(x.device)
        h = self.proj_in(x.to(dtype)).transpose(1, 2)  # [B, T, H]

        # +-2 frame reconciliation of the acoustic stream with the latent
        T, Ta = h.shape[1], acoustic.shape[1]
        if T > Ta:
            acoustic = torch.cat([acoustic, acoustic[:, -1:].expand(-1, T - Ta, -1)], dim=1)
        elif Ta > T:
            acoustic = acoustic[:, :T]

        t_emb = self.t_embedder(t)
        h = acoustic + h
        adaln_input = t_emb + cap_emb
        lb_total = 0.0
        for block in self.layers:
            noise = None
            if train and gumbel is not None:
                noise = [draw_gumbel(gumbel, shape, h)
                         for shape in block.feed_forward.noise_shapes(h.shape[0], T)]
            args = (h, None, caption, None, rope_cos, rope_sin, adaln_input,
                    t_emb, caption, acoustic, step, train, noise)
            if self.remat and torch.is_grad_enabled():
                h, lb = checkpoint(block, *args, use_reentrant=False)
            else:
                h, lb = block(*args)
            lb_total = lb_total + lb
        lb_loss = lb_total / self.depth * anneal_loss_weight(step)
        out = self.final_layer(h, adaln_input)
        return out.transpose(1, 2), lb_loss
