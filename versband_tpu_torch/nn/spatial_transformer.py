"""SpatialTransformer, the 2-D token transformer of the legacy 2-D UNet path
(port of ``versband_tpu/nn/spatial_transformer.py``, after the reference's
``ldm/modules/attention.py``).

Images are ``[B, C, H, W]``; inside, tokens are ``[B, H*W, inner]``. Each
block: LN -> self-attention, LN -> cross-attention to ``context`` (self when
there is none), LN -> GEGLU FFN (exact GELU), each residual. The output
projection starts at zero, so a fresh transformer is the identity.
``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``) instead of keeping its activations. Parameter
names are the reference's (``transformer_blocks.{i}.attn2.to_k``,
``ff.net.0.proj``, ``ff.net.2``); LayerNorms take flax's epsilon, 1e-6.

The JAX module passes its attention's arguments in the wrong order
(``CrossAttention(dim, None, n_heads, d_head)`` against the fields
``query_dim, heads, dim_head``) and cannot run; this port computes what the
reference and the JAX docstring describe.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from versband_tpu_torch.models.concat_dit import CrossAttention


class GEGLU(nn.Module):
    """``proj``: Linear to ``2 dim_out``, then h * gelu(gate)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """``net``: GEGLU to ``4 dim``, (dropout), Linear back to ``dim``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, n_heads, d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """``[B, C, H, W]`` (+ context ``[B, Ty, context_dim]``) -> ``[B, C, H, W]``."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, remat: bool = False):
        super().__init__()
        inner = n_heads * d_head
        self.remat = remat
        self.norm = nn.GroupNorm(min(32, in_channels), in_channels, eps=1e-6)
        self.proj_in = nn.Conv2d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, n_heads, d_head, context_dim) for _ in range(depth)])
        self.proj_out = nn.Conv2d(inner, in_channels, 1)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        inner = h.shape[1]
        h = h.flatten(2).transpose(1, 2)  # [B, H*W, inner]
        for blk in self.transformer_blocks:
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(blk, h, context, use_reentrant=False)
            else:
                h = blk(h, context)
        h = h.transpose(1, 2).reshape(B, inner, H, W)
        return x + self.proj_out(h)
