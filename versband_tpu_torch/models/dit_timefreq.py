"""The Time/Freq-MoE DiT (port of ``versband_tpu/models/dit_timefreq.py``),
the reference's ``VideoFlagLargeDiT``.

Each block: adaLN-zero modulation, gated joint attention (RoPE self-attention
plus the tanh-gated cross path over the caption tokens, plain
:func:`~versband_tpu_torch.nn.core.sdpa` as in JAX, no flash kernel), then
the Time/Freq MoE FFN:

* time experts: hard routing of whole sequences by timestep,
  ``t // (num_timesteps // E)``, to one of E SwiGLU FFNs (hidden 4 dim by the
  2/3 rule);
* frequency experts: expert e takes the time experts' output masked to the
  e-th contiguous channel band, and its output is kept on that band.

Both groups are evaluated densely and mixed by one-hot / band masks, as the
JAX package does. Parameter names are the reference's
(``layers.{i}.feed_forward.time_experts.{e}.w1``, ``layers.{i}.attention.wk_y``,
``cap_embedder.1``, ...). The model answers ``(v, 0.0)``: the routing is hard,
there is no load-balance loss.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from versband_tpu_torch.models.dit import BandMoeDiT, FinalLayer, StackedSwiGLU
from versband_tpu_torch.nn.core import (
    ConditionEmbedder, JointAttention, RMSNorm, TimestepEmbedder, modulate)
from versband_tpu_torch.parallel import copy_to_model, reduce_from_model


def time_expert_index(t: torch.Tensor, num_experts: int, num_timesteps: int = 1000
                      ) -> torch.Tensor:
    """The time expert of each sequence: ``clip(int(t) // (num_timesteps // E), 0, E-1)``."""
    return torch.clamp(t.to(torch.int32) // (num_timesteps // num_experts), 0, num_experts - 1)


class TimeFreqMoE(nn.Module):
    """Hard time-routed experts, then frequency-band experts.

    Cut by ``parallel.sharding.shard_module_`` (``tp_group`` set), a rank
    holds ``E / n_model`` of the frequency experts and every time expert (no
    rule names them, in JAX neither): the time experts' output, whole on
    every rank, enters this rank's frequency experts through
    ``copy_to_model`` (the backward sums the ranks' parts of its gradient, so
    the time experts' gradients are whole and alike), and the bands' mix is
    summed over the model group."""

    def __init__(self, dim: int, hidden_dim: int, num_experts: int = 4, multiple_of: int = 256,
                 num_timesteps: int = 1000):
        super().__init__()
        self.num_experts, self.num_timesteps = num_experts, num_timesteps
        self.time_experts = StackedSwiGLU(num_experts, dim, hidden_dim, multiple_of)
        self.freq_experts = StackedSwiGLU(num_experts, dim, hidden_dim, multiple_of)
        self.tp_group = None  # the model group sharing the frequency experts

    def band_mask(self, dim: int, like: torch.Tensor) -> torch.Tensor:
        """``[E, dim]``: 1 on expert e's channels ``[e band, (e+1) band)``."""
        E = self.num_experts
        band = dim // E
        ch = torch.arange(dim, device=like.device)
        lo = band * torch.arange(E, device=like.device)[:, None]
        return ((ch[None, :] >= lo) & (ch[None, :] < lo + band)).to(like.dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        onehot = F.one_hot(time_expert_index(t, self.num_experts, self.num_timesteps).long(),
                           self.num_experts).to(x.dtype)  # [B, E]
        y = torch.einsum("ebtd,be->btd", self.time_experts.dense(x), onehot)
        mask = self.band_mask(x.shape[-1], y)
        group = self.tp_group
        if group is not None:
            y, mask = copy_to_model(y, group), mask[self.freq_experts.local()]
        freq_out = self.freq_experts.dense(y[None] * mask[:, None, None, :])
        return reduce_from_model(torch.einsum("ebtd,ed->btd", freq_out, mask), group)


class TimeFreqBlock(nn.Module):
    """adaLN (6-way) -> gated joint attention over (x, caption) -> Time/Freq MoE."""

    def __init__(self, dim: int, n_heads: int, num_experts: int = 4,
                 n_kv_heads: Optional[int] = None, multiple_of: int = 256,
                 norm_eps: float = 1e-5, qk_norm: bool = False):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(dim, 6 * dim))
        nn.init.zeros_(self.adaLN_modulation[1].weight)
        nn.init.zeros_(self.adaLN_modulation[1].bias)
        self.attention_norm = RMSNorm(dim, norm_eps)
        self.attention_y_norm = RMSNorm(dim, norm_eps)
        self.ffn_norm = RMSNorm(dim, norm_eps)
        self.attention = JointAttention(dim, n_heads, n_kv_heads, qk_norm, dim)
        self.feed_forward = TimeFreqMoE(dim, 4 * dim, num_experts, multiple_of)

    def forward(self, x, y, rope_cos, rope_sin, adaln_input, t):
        (s_msa, sc_msa, g_msa,
         s_mlp, sc_mlp, g_mlp) = self.adaLN_modulation(adaln_input).chunk(6, dim=-1)
        attn_in = modulate(self.attention_norm(x), s_msa, sc_msa)
        h = x + g_msa[:, None, :] * self.attention(attn_in, None, rope_cos, rope_sin,
                                                   self.attention_y_norm(y), None)
        out = self.feed_forward(modulate(self.ffn_norm(h), s_mlp, sc_mlp), t)
        return h + g_mlp[:, None, :] * out


class TimeFreqMoeDiT(nn.Module):
    """``(x [B, C, T], t [B], context [B, Ty, ctx] or {'c_crossattn': ...})
    -> (v [B, C, T], 0.0)``; latent plus caption, no acoustic stream. The
    defaults are the reference's ``VideoFlagLargeDiT``'s."""

    def __init__(self, in_channels: int, context_dim: int, hidden_size: int = 1152,
                 depth: int = 28, num_heads: int = 16, max_len: int = 1000,
                 num_experts: int = 8, n_kv_heads: Optional[int] = None,
                 multiple_of: int = 256, norm_eps: float = 1e-5, qk_norm: bool = False,
                 rope_scaling_factor: float = 1.0, ntk_factor: float = 1.0):
        super().__init__()
        self.in_channels = in_channels
        self.head_dim = hidden_size // num_heads
        self.max_len = max_len
        self.rope_scaling_factor = rope_scaling_factor
        self.ntk_factor = ntk_factor
        self._rope: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.proj_in = nn.Linear(in_channels, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.c_embedder = ConditionEmbedder(context_dim, hidden_size)
        self.cap_embedder = nn.Sequential(nn.LayerNorm(hidden_size, eps=1e-6),
                                          nn.Linear(hidden_size, hidden_size))
        nn.init.xavier_uniform_(self.cap_embedder[1].weight)
        self.layers = nn.ModuleList([
            TimeFreqBlock(hidden_size, num_heads, num_experts, n_kv_heads, multiple_of,
                          norm_eps, qk_norm) for _ in range(depth)])
        self.final_layer = FinalLayer(hidden_size, in_channels)

    rope_tables = BandMoeDiT.rope_tables

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: Any, step: int = 0,
                train: bool = False):
        if isinstance(context, dict):
            context = context.get("c_crossattn", context)
        dtype = self.proj_in.weight.dtype
        rope_cos, rope_sin = self.rope_tables(x.device)
        h = self.proj_in(x.to(dtype).transpose(1, 2))
        c = self.c_embedder(context.to(dtype))
        adaln_input = self.t_embedder(t) + self.cap_embedder(c.mean(dim=1))
        for block in self.layers:
            h = block(h, c, rope_cos, rope_sin, adaln_input, t)
        return self.final_layer(h, adaln_input).transpose(1, 2), 0.0
