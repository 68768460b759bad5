"""1-D KL-VAE mel codec (port of ``versband_tpu/models/autoencoder.py``).

Shipped config (``configs/vocal2music.yaml`` first_stage_config): 80-bin mel
<-> 20-channel latent, ch 384, ch_mult (1, 2, 4), 2 res blocks, kernel 5, one
2x temporal downsample at level 0, single-head attention in the mid block,
GroupNorm(32, eps 1e-6) + swish. Tensors are channel-first ``[B, C, T]``
throughout. The reference's kernel asymmetry is kept: encoder res blocks use
the configured kernel (5), decoder res blocks the default 3. Parameter names
are the reference's (``decoder.up.{i}.block.{j}.conv1``, ``decoder.mid.attn_1.q``, ...).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from versband_tpu_torch.models.distributions import DiagonalGaussian


def _norm(channels: int) -> nn.GroupNorm:
    # GroupNorm(32); fewer groups at widths below 32 (tiny test models)
    return nn.GroupNorm(32 if channels >= 32 else channels, channels, eps=1e-6)


def _conv(cin: int, cout: int, k: int) -> nn.Conv1d:
    return nn.Conv1d(cin, cout, k, padding=k // 2)


class ResnetBlock1D(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 kernel_size: int = 3, dropout: float = 0.0):
        super().__init__()
        out_ch = out_channels or in_channels
        self.norm1 = _norm(in_channels)
        self.conv1 = _conv(in_channels, out_ch, kernel_size)
        self.norm2 = _norm(out_ch)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = _conv(out_ch, out_ch, kernel_size)
        self.nin_shortcut = nn.Conv1d(in_channels, out_ch, 1) if in_channels != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(self.dropout(F.silu(self.norm2(h))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock1D(nn.Module):
    """Single-head self-attention over time with 1x1-conv projections; fp32 softmax."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.norm = _norm(in_channels)
        self.q = nn.Conv1d(in_channels, in_channels, 1)
        self.k = nn.Conv1d(in_channels, in_channels, 1)
        self.v = nn.Conv1d(in_channels, in_channels, 1)
        self.proj_out = nn.Conv1d(in_channels, in_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(x)
        q, k, v = self.q(h), self.k(h), self.v(h)  # [B, C, T]
        logits = torch.einsum("bcq,bck->bqk", q.float(), k.float()) * q.shape[1] ** -0.5
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        h = torch.einsum("bqk,bck->bcq", w.float(), v.float()).to(x.dtype)
        return x + self.proj_out(h)


class Downsample1D(nn.Module):
    """Pad (0, 1) then a stride-2 valid conv, as the reference."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, in_channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1)))


class Upsample1D(nn.Module):
    """Nearest-neighbour 2x in time, then a k3 conv."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv = _conv(in_channels, in_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.repeat_interleave(x, 2, dim=2))


class _Mid(nn.Module):
    def __init__(self, ch: int, kernel_size: int, dropout: float):
        super().__init__()
        self.block_1 = ResnetBlock1D(ch, kernel_size=kernel_size, dropout=dropout)
        self.attn_1 = AttnBlock1D(ch)
        self.block_2 = ResnetBlock1D(ch, kernel_size=kernel_size, dropout=dropout)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


class _Level(nn.Module):
    """One resolution level: ``block.{j}``, ``attn.{j}`` and an optional resampler."""

    def __init__(self, cin: int, cout: int, n_blocks: int, kernel_size: int,
                 dropout: float, attn: bool):
        super().__init__()
        self.block = nn.ModuleList([
            ResnetBlock1D(cin if j == 0 else cout, cout, kernel_size, dropout)
            for j in range(n_blocks)])
        self.attn = nn.ModuleList([AttnBlock1D(cout) for _ in range(n_blocks)] if attn else [])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for j, blk in enumerate(self.block):
            h = blk(h)
            if len(self.attn):
                h = self.attn[j](h)
        return h


class Encoder1D(nn.Module):
    """``[B, in_channels, T] -> [B, 2*z_channels, T']``."""

    def __init__(self, ch: int, ch_mult: Sequence[int] = (1, 2, 4, 8), num_res_blocks: int = 2,
                 attn_layers: Sequence[int] = (), down_layers: Sequence[int] = (),
                 in_channels: int = 80, z_channels: int = 20, double_z: bool = True,
                 kernel_size: int = 3, dropout: float = 0.0):
        super().__init__()
        k = kernel_size
        self.conv_in = _conv(in_channels, ch, k)
        in_mult = (1,) + tuple(ch_mult)
        self.down = nn.ModuleList()
        for i, mult in enumerate(ch_mult):
            lvl = _Level(ch * in_mult[i], ch * mult, num_res_blocks, k, dropout,
                         i in attn_layers)
            if i in down_layers:
                lvl.downsample = Downsample1D(ch * mult)
            self.down.append(lvl)
        block_in = ch * ch_mult[-1]
        self.mid = _Mid(block_in, k, dropout)
        self.norm_out = _norm(block_in)
        self.conv_out = _conv(block_in, 2 * z_channels if double_z else z_channels, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for lvl in self.down:
            h = lvl(h)
            if hasattr(lvl, "downsample"):
                h = lvl.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder1D(nn.Module):
    """``[B, z_channels, T'] -> [B, out_ch, T]``; res blocks at the default k=3."""

    def __init__(self, ch: int, out_ch: int = 80, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, attn_layers: Sequence[int] = (),
                 down_layers: Sequence[int] = (), z_channels: int = 20,
                 kernel_size: int = 3, dropout: float = 0.0):
        super().__init__()
        k = kernel_size
        # each encoder downsample moves the matching decoder upsample one level up
        up_layers = [i + 1 for i in down_layers]
        block_in = ch * ch_mult[-1]
        self.conv_in = _conv(z_channels, block_in, k)
        self.mid = _Mid(block_in, 3, dropout)
        up = [None] * len(ch_mult)
        for i in reversed(range(len(ch_mult))):
            block_out = ch * ch_mult[i]
            lvl = _Level(block_in, block_out, num_res_blocks + 1, 3, dropout, i in attn_layers)
            if i in up_layers:
                lvl.upsample = Upsample1D(block_out)
            up[i] = lvl
            block_in = block_out
        self.up = nn.ModuleList(up)
        self.norm_out = _norm(block_in)
        self.conv_out = _conv(block_in, out_ch, k)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for i in reversed(range(len(self.up))):
            lvl = self.up[i]
            h = lvl(h)
            if hasattr(lvl, "upsample"):
                h = lvl.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """KL-VAE over mel spectrograms: ``encode: [B, 80, T] -> DiagonalGaussian``,
    ``decode: [B, embed_dim, T/2] -> [B, 80, T]``. ``ckpt_path``, ``lossconfig``
    and the other training keys of the YAML are accepted and unused here."""

    def __init__(self, embed_dim: int, ddconfig: Optional[dict] = None,
                 lossconfig: Any = None, ckpt_path: Optional[str] = None,
                 ignore_keys: Sequence[str] = (), image_key: str = "image",
                 monitor: Optional[str] = None):
        super().__init__()
        dd = dict(ddconfig or {})
        if not dd.get("double_z", True):
            raise ValueError("AutoencoderKL needs double_z: true")
        common = dict(ch=dd["ch"], ch_mult=tuple(dd.get("ch_mult", (1, 2, 4))),
                      num_res_blocks=dd.get("num_res_blocks", 2),
                      attn_layers=tuple(dd.get("attn_layers", ())),
                      down_layers=tuple(dd.get("down_layers", ())),
                      z_channels=dd["z_channels"], kernel_size=dd.get("kernel_size", 3),
                      dropout=dd.get("dropout", 0.0))
        self.encoder = Encoder1D(in_channels=dd["in_channels"], double_z=True, **common)
        self.decoder = Decoder1D(out_ch=dd["out_ch"], **common)
        self.quant_conv = nn.Conv1d(2 * dd["z_channels"], 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv1d(embed_dim, dd["z_channels"], 1)
        self.downsample_factor = 2 ** len(common["down_layers"])

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        moments = self.quant_conv(self.encoder(x.to(self.quant_conv.weight.dtype)))
        return DiagonalGaussian(moments, channel_axis=1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                sample_posterior: bool = True):
        posterior = self.encode(x)
        z = posterior.sample(generator) if sample_posterior else posterior.mode()
        return self.decode(z), posterior
