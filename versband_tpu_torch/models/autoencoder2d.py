"""The legacy 2-D autoencoder family (port of
``versband_tpu/models/autoencoder2d.py``): ``AutoencoderKL2D``, ``VQModel``,
``VQModelInterface`` and ``IdentityFirstStage``, the first stages of the 2-D
LDM configs (the reference's ``ldm/models/autoencoder.py``).

Images are ``[B, C, H, W]`` and stay NCHW inside. Blocks: GroupNorm(32, eps
1e-6) + swish res blocks, single-head spatial attention (fp32 softmax) in the
mid block and at ``attn_resolutions`` in the encoder, a stride-2 conv after a
``(0, 1)`` pad on each spatial axis to go down, nearest 2x then a conv to go
up. Parameter names are the reference's (``encoder.down.{i}.block.{j}``,
``decoder.up.{i}.upsample.conv``, ``quantize.embedding.weight``, ...).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from versband_tpu_torch.models.distributions import DiagonalGaussian


def _norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, ch), ch, eps=1e-6)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None):
        super().__init__()
        out_ch = out_channels or in_channels
        self.norm1 = _norm(in_channels)
        self.conv1 = _conv3(in_channels, out_ch)
        self.norm2 = _norm(out_ch)
        self.conv2 = _conv3(out_ch, out_ch)
        self.nin_shortcut = nn.Conv2d(in_channels, out_ch, 1) if in_channels != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock2D(nn.Module):
    """Single-head self-attention over the H*W positions, 1x1-conv projections."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.norm = _norm(in_channels)
        self.q = nn.Conv2d(in_channels, in_channels, 1)
        self.k = nn.Conv2d(in_channels, in_channels, 1)
        self.v = nn.Conv2d(in_channels, in_channels, 1)
        self.proj_out = nn.Conv2d(in_channels, in_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x)
        q, k, v = (m(h).reshape(B, C, H * W).float() for m in (self.q, self.k, self.v))
        w = torch.softmax(torch.einsum("bci,bcj->bij", q, k) * C ** -0.5, dim=-1)
        h = torch.einsum("bij,bcj->bci", w, v).reshape(B, C, H, W).to(x.dtype)
        return x + self.proj_out(h)


class Downsample2D(nn.Module):
    """Pad (0, 1) on H and W, then a stride-2 valid 3x3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(h, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    """Nearest 2x (each pixel repeated: ``jax.image.resize``'s nearest at an
    exact 2x), then a 3x3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = _conv3(ch, ch)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv(h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock2D(ch)
        self.attn_1 = AttnBlock2D(ch)
        self.block_2 = ResnetBlock2D(ch)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


class _Level(nn.Module):
    """``block.{j}``, ``attn.{j}`` (after each block, where present) and an
    optional ``downsample`` / ``upsample``."""

    def __init__(self, cin: int, cout: int, n_blocks: int, attn: bool):
        super().__init__()
        self.block = nn.ModuleList([ResnetBlock2D(cin if j == 0 else cout, cout)
                                    for j in range(n_blocks)])
        self.attn = nn.ModuleList([AttnBlock2D(cout) for _ in range(n_blocks)] if attn else [])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for j, blk in enumerate(self.block):
            h = blk(h)
            if len(self.attn):
                h = self.attn[j](h)
        return h


class Encoder2D(nn.Module):
    """``[B, in_channels, H, W] -> [B, (2 x) z_channels, H', W']``."""

    def __init__(self, ch: int, ch_mult: Sequence[int] = (1, 2, 4, 8), num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), in_channels: int = 3,
                 resolution: int = 256, z_channels: int = 4, double_z: bool = True):
        super().__init__()
        self.conv_in = _conv3(in_channels, ch)
        self.down = nn.ModuleList()
        cin, res = ch, resolution
        for i, mult in enumerate(ch_mult):
            lvl = _Level(cin, ch * mult, num_res_blocks, res in attn_resolutions)
            if i != len(ch_mult) - 1:
                lvl.downsample = Downsample2D(ch * mult)
                res //= 2
            self.down.append(lvl)
            cin = ch * mult
        self.mid = _Mid(cin)
        self.norm_out = _norm(cin)
        self.conv_out = _conv3(cin, 2 * z_channels if double_z else z_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for lvl in self.down:
            h = lvl(h)
            if hasattr(lvl, "downsample"):
                h = lvl.downsample(h)
        return self.conv_out(F.silu(self.norm_out(self.mid(h))))


class Decoder2D(nn.Module):
    """``[B, z_channels, H', W'] -> [B, out_ch, H, W]``; no attention in the
    up levels (as in JAX)."""

    def __init__(self, ch: int, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 z_channels: int = 4):
        super().__init__()
        cin = ch * ch_mult[-1]
        self.conv_in = _conv3(z_channels, cin)
        self.mid = _Mid(cin)
        up = [None] * len(ch_mult)
        for i in reversed(range(len(ch_mult))):
            lvl = _Level(cin, ch * ch_mult[i], num_res_blocks + 1, False)
            if i != 0:
                lvl.upsample = Upsample2D(ch * ch_mult[i])
            up[i] = lvl
            cin = ch * ch_mult[i]
        self.up = nn.ModuleList(up)
        self.norm_out = _norm(cin)
        self.conv_out = _conv3(cin, out_ch)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for i in reversed(range(len(self.up))):
            lvl = self.up[i]
            h = lvl(h)
            if hasattr(lvl, "upsample"):
                h = lvl.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


def _coders(dd: dict, double_z: bool) -> Tuple[Encoder2D, Decoder2D]:
    common = dict(ch=dd["ch"], ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 8))),
                  num_res_blocks=dd.get("num_res_blocks", 2),
                  attn_resolutions=tuple(dd.get("attn_resolutions", ())),
                  z_channels=dd["z_channels"])
    return (Encoder2D(in_channels=dd.get("in_channels", 3),
                      resolution=dd.get("resolution", 256), double_z=double_z, **common),
            Decoder2D(out_ch=dd.get("out_ch", 3), **common))


class VectorQuantizer(nn.Module):
    """Nearest-codebook quantizer over the channel axis of ``[B, C, H, W]``:
    ``(zq, loss, indices [B, H, W])`` with ``loss = beta |sg(zq) - z|^2 +
    |zq - sg(z)|^2`` (means) and the straight-through ``zq = z + sg(zq - z)``.
    Ties go to the first index, as ``jnp.argmin``'s."""

    def __init__(self, n_embed: int, embed_dim: int, beta: float = 0.25):
        super().__init__()
        self.embed_dim, self.beta = embed_dim, beta
        self.embedding = nn.Embedding(n_embed, embed_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / n_embed, 1.0 / n_embed)

    def forward(self, z: torch.Tensor):
        zl = z.permute(0, 2, 3, 1)  # channels last, as the distances are taken
        cb = self.embedding.weight
        flat = zl.reshape(-1, self.embed_dim)
        d = (flat.pow(2).sum(1, keepdim=True) - 2 * flat @ cb.t() + cb.pow(2).sum(1))
        idx = torch.argmin(d, dim=1)
        zq = cb[idx].reshape(zl.shape)
        loss = (self.beta * torch.mean((zq.detach() - zl) ** 2)
                + torch.mean((zq - zl.detach()) ** 2))
        zq = zl + (zq - zl).detach()
        return zq.permute(0, 3, 1, 2), loss, idx.reshape(zl.shape[:-1])


class AutoencoderKL2D(nn.Module):
    """2-D KL autoencoder: ``encode: [B, C, H, W] -> DiagonalGaussian`` over
    ``2 embed_dim`` moments, ``decode: [B, embed_dim, H', W'] -> [B, out_ch,
    H, W]``. ``lossconfig``, ``ckpt_path`` and the other training keys are
    accepted and unused."""

    def __init__(self, embed_dim: int, ddconfig: Optional[dict] = None, lossconfig: Any = None,
                 ckpt_path: Optional[str] = None, image_key: str = "image",
                 monitor: Optional[str] = None, **kwargs):
        super().__init__()
        dd = dict(ddconfig or {})
        double_z = dd.get("double_z", True)
        self.encoder, self.decoder = _coders(dd, double_z)
        self.quant_conv = nn.Conv2d((2 if double_z else 1) * dd["z_channels"], 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, dd["z_channels"], 1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        moments = self.quant_conv(self.encoder(x.to(self.quant_conv.weight.dtype)))
        return DiagonalGaussian(moments, channel_axis=1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                sample_posterior: bool = True, noise: Optional[torch.Tensor] = None):
        post = self.encode(x)
        z = post.sample(generator, noise) if sample_posterior else post.mode()
        return self.decode(z), post


class VQModel(nn.Module):
    """2-D VQ autoencoder: ``encode`` -> ``(zq, loss, indices)``,
    ``decode(z, force_not_quantize=False)`` quantizes first unless told not
    to, ``forward(x) -> (reconstruction, loss)``."""

    def __init__(self, embed_dim: int, n_embed: int, ddconfig: Optional[dict] = None,
                 lossconfig: Any = None, ckpt_path: Optional[str] = None,
                 monitor: Optional[str] = None, **kwargs):
        super().__init__()
        dd = dict(ddconfig or {})
        self.encoder, self.decoder = _coders(dd, False)
        self.quantize = VectorQuantizer(n_embed, embed_dim)
        self.quant_conv = nn.Conv2d(dd["z_channels"], embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, dd["z_channels"], 1)

    def encode_pre_quant(self, x: torch.Tensor) -> torch.Tensor:
        """The latents before quantization (``VQModelInterface.encode``)."""
        return self.quant_conv(self.encoder(x.to(self.quant_conv.weight.dtype)))

    def encode_quantized(self, x: torch.Tensor):
        return self.quantize(self.encode_pre_quant(x))

    def encode(self, x: torch.Tensor):
        return self.encode_quantized(x)

    def decode(self, z: torch.Tensor, force_not_quantize: bool = False) -> torch.Tensor:
        if not force_not_quantize:
            z, _, _ = self.quantize(z)
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor):
        zq, loss, _ = self.encode_quantized(x)
        return self.decode(zq, force_not_quantize=True), loss


class VQModelInterface(VQModel):
    """First-stage interface: ``encode`` returns the latents before
    quantization; ``decode`` quantizes."""

    def encode(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return self.encode_pre_quant(x)


class IdentityFirstStage(nn.Module):
    """Pass-through first stage; ``quantize`` answers the VQ interface's
    triple when ``vq_interface``."""

    def __init__(self, *args, vq_interface: bool = False, **kwargs):
        super().__init__()
        self.vq_interface = vq_interface

    def encode(self, x, *args, **kwargs):
        return x

    def decode(self, x, *args, **kwargs):
        return x

    def quantize(self, x, *args, **kwargs):
        if self.vq_interface:
            return x, None, [None, None, None]
        return x

    def forward(self, x, *args, **kwargs):
        return x
