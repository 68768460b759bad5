"""Core NN primitives of the Band-MoE DiT stack (port of ``versband_tpu/nn/core.py``).

Sequence tensors are ``[B, T, C]``, attention tensors ``[B, T, H, D]`` and
masks ``[B, T]`` with 1 = valid, as in the JAX package. Parameter names follow
the reference checkpoints, so a released state_dict loads unchanged.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from versband_tpu_torch.ops.flash_attention import flash_attention
from versband_tpu_torch.parallel import copy_to_model, reduce_from_model

_NEG = float(torch.finfo(torch.float32).min)


class RMSNorm(nn.Module):
    """y = x / sqrt(mean(x^2) + eps) * w: normalised in fp32, cast, then scaled."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return normed.to(x.dtype) * self.weight.to(x.dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation: x * (1 + scale) + shift, with [B, C] conditioners."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0
                       ) -> torch.Tensor:
    """Sinusoidal fp32 embedding of (possibly fractional) timesteps, cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(nn.Linear(frequency_embedding_size, hidden_size),
                                 nn.SiLU(), nn.Linear(hidden_size, hidden_size))
        for i in (0, 2):
            nn.init.normal_(self.mlp[i].weight, std=0.02)
            nn.init.zeros_(self.mlp[i].bias)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp(x.to(self.mlp[0].weight.dtype))


class ConditionEmbedder(nn.Module):
    """Caption projection: Linear -> GELU (exact unless ``gelu_tanh``) -> Linear -> LayerNorm."""

    def __init__(self, in_dim: int, hidden_size: int, gelu_tanh: bool = False):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(in_dim, hidden_size),
                                 nn.GELU(approximate="tanh" if gelu_tanh else "none"),
                                 nn.Linear(hidden_size, hidden_size))
        self.norm = nn.LayerNorm(hidden_size, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.mlp(x))


def swiglu_hidden_dim(hidden_dim: int, multiple_of: int = 256,
                      ffn_dim_multiplier: Optional[float] = None) -> int:
    """The Llama/Lumina SwiGLU hidden-size rule."""
    hidden_dim = int(2 * hidden_dim / 3)
    if ffn_dim_multiplier is not None:
        hidden_dim = int(ffn_dim_multiplier * hidden_dim)
    return multiple_of * ((hidden_dim + multiple_of - 1) // multiple_of)


class FeedForward(nn.Module):
    """SwiGLU FFN: w2(silu(w1 x) * w3 x), no biases."""

    def __init__(self, dim: int, hidden_dim: int, multiple_of: int = 256,
                 ffn_dim_multiplier: Optional[float] = None):
        super().__init__()
        h = swiglu_hidden_dim(hidden_dim, multiple_of, ffn_dim_multiplier)
        self.w1 = nn.Linear(dim, h, bias=False)
        self.w2 = nn.Linear(h, dim, bias=False)
        self.w3 = nn.Linear(dim, h, bias=False)
        for lin in (self.w1, self.w2, self.w3):
            nn.init.xavier_uniform_(lin.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


def precompute_rope(dim: int, end: int, theta: float = 10000.0,
                    rope_scaling_factor: float = 1.0, ntk_factor: float = 1.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) fp32 tables ``[end, dim//2]`` with ntk and position scaling."""
    theta = theta * ntk_factor
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim))
    t = np.arange(end, dtype=np.float64) / rope_scaling_factor
    ang = np.outer(t, freqs)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs (x[2i], x[2i+1]) of ``x`` [B, T, H, D] by position, in fp32."""
    T = x.shape[1]
    if T > cos.shape[0]:
        raise ValueError(f"sequence length {T} exceeds the RoPE table ({cos.shape[0]}); "
                         "increase the model's max_len")
    xf = x.float()
    a, b = xf[..., 0::2], xf[..., 1::2]
    c = cos[None, :T, None, :]
    s = sin[None, :T, None, :]
    out = torch.stack([a * c - b * s, a * s + b * c], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None, scale: Optional[float] = None) -> torch.Tensor:
    """Masked attention over ``[B, T, H, D]``: fp32 logits and softmax, probs
    cast to the input type before P.V (fp32 accumulation)."""
    dtype = q.dtype
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :].bool(), _NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype).float(), v.float())
    return out.to(dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
              use_flash: bool = False) -> torch.Tensor:
    """Dispatch between :func:`sdpa` and flash attention (kernel K1 on CUDA).

    ``use_flash`` assumes the mask, if any, is a contiguous valid prefix and
    passes per-example valid lengths to the kernel.
    """
    if use_flash:
        kv_len = None if mask is None else mask.to(torch.int32).sum(-1)
        return flash_attention(q, k, v, kv_len=kv_len, scale=scale)
    return sdpa(q, k, v, mask, scale)


class JointAttention(nn.Module):
    """Self-attention with RoPE plus an optional zero-init tanh-gated
    cross-attention over ``y``; GQA through ``n_kv_heads``. The cross path
    always uses :func:`sdpa` (text keys are short).

    Cut by ``parallel.sharding.shard_module_`` (``tp_group`` set), it holds
    ``n_local`` of the heads: column-parallel ``wq/wk/wv(_y)``, this rank's
    slice of the whole per-head ``gate``, and a row-parallel ``wo`` whose
    partial products are summed over the model group."""

    def __init__(self, dim: int, n_heads: int, n_kv_heads: Optional[int] = None,
                 qk_norm: bool = False, y_dim: int = 0, use_flash: bool = False,
                 proportional_attn: bool = False, base_seqlen: Optional[int] = None):
        super().__init__()
        self.n_heads = n_heads
        self.n_kv = n_kv_heads or n_heads
        self.head_dim = dim // n_heads
        self.y_dim = y_dim
        self.use_flash = use_flash
        self.proportional_attn = proportional_attn
        self.base_seqlen = base_seqlen
        # this rank's heads under tensor parallelism (all of them otherwise)
        self.tp_group = None
        self.n_local, self.kv_local, self.head_offset = n_heads, self.n_kv, 0
        hd, nkv = self.head_dim, self.n_kv
        self.wq = nn.Linear(dim, n_heads * hd, bias=False)
        self.wk = nn.Linear(dim, nkv * hd, bias=False)
        self.wv = nn.Linear(dim, nkv * hd, bias=False)
        self.wo = nn.Linear(n_heads * hd, dim, bias=False)
        lins = [self.wq, self.wk, self.wv, self.wo]
        if qk_norm:
            self.q_norm = nn.LayerNorm(n_heads * hd, eps=1e-6)
            self.k_norm = nn.LayerNorm(nkv * hd, eps=1e-6)
        else:
            self.q_norm = self.k_norm = None
        if y_dim > 0:
            self.wk_y = nn.Linear(y_dim, nkv * hd, bias=False)
            self.wv_y = nn.Linear(y_dim, nkv * hd, bias=False)
            self.ky_norm = nn.LayerNorm(nkv * hd, eps=1e-6) if qk_norm else None
            self.gate = nn.Parameter(torch.zeros(n_heads))
            lins += [self.wk_y, self.wv_y]
        for lin in lins:
            nn.init.xavier_uniform_(lin.weight)

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor],
                rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                y_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape
        hd, n_rep = self.head_dim, self.n_heads // self.n_kv
        H, Hkv, group = self.n_local, self.kv_local, self.tp_group
        x = copy_to_model(x, group)
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        q = apply_rope(q.view(B, T, H, hd), rope_cos, rope_sin)
        k = apply_rope(k.view(B, T, Hkv, hd), rope_cos, rope_sin)
        v = v.view(B, T, Hkv, hd)
        if n_rep > 1:
            k = k.repeat_interleave(n_rep, dim=2)
            v = v.repeat_interleave(n_rep, dim=2)

        scale = None
        if self.proportional_attn and self.base_seqlen and T > 1:
            scale = math.sqrt(math.log(T, self.base_seqlen) / hd)
        out = attention(q, k, v, x_mask, scale=scale, use_flash=self.use_flash)

        if self.y_dim > 0 and y is not None:
            y = copy_to_model(y, group)
            Ty = y.shape[1]
            ky = self.wk_y(y)
            if self.ky_norm is not None:
                ky = self.ky_norm(ky)
            ky = ky.view(B, Ty, Hkv, hd)
            vy = self.wv_y(y).view(B, Ty, Hkv, hd)
            if n_rep > 1:
                ky = ky.repeat_interleave(n_rep, dim=2)
                vy = vy.repeat_interleave(n_rep, dim=2)
            out_y = sdpa(q, ky, vy, y_mask)
            gate = self.gate
            if group is not None:
                gate = copy_to_model(gate, group)[self.head_offset:self.head_offset + H]
            out = out + out_y * torch.tanh(gate).to(out.dtype)[None, None, :, None]
        return reduce_from_model(self.wo(out.reshape(B, T, H * hd)), group)
