"""HiFi-GAN vocoder (port of ``versband_tpu/vocoder/hifigan.py``).

``HifiGanGenerator`` maps a mel ``[B, 80, T]`` to a waveform ``[B, T*hop]``
with plain (weight-norm folded) ``nn.Conv1d`` / ``nn.ConvTranspose1d``, or,
with ``use_weight_norm=True``, the trainable form whose every conv holds
(``weight_v``, ``weight_g``) in the JAX package's convention
(``vocoder/conv.py``; ``fold_weight_norm_`` gives the serving form).
Parameter names are the reference's (``conv_pre``, ``ups.{i}``,
``resblocks.{i*K+j}.convs1.{n}``, ``conv_post``). Defaults are the 24 kHz /
hop-320 generator: upsample rates (5, 4, 4, 4), kernels (9, 8, 8, 8).
``CodeUpsampleHifiGanGenerator`` is the codec-token variant (``code_embed``,
then ``generator``). ``HifiGAN`` is the runtime wrapper that loads a
checkpoint directory.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from versband_tpu_torch.device import DeviceLike, resolve_device
from versband_tpu_torch.nn.rounding import leaky_relu
from versband_tpu_torch.utils.checkpoint import get_last_checkpoint
from versband_tpu_torch.vocoder.conv import (LRELU_SLOPE, apply_weight_norm,
                                             fold_torch_weight_norm, get_padding)


def _conv(ch_in: int, ch_out: int, k: int, dilation: int = 1, std: Optional[float] = 0.01):
    conv = nn.Conv1d(ch_in, ch_out, k, dilation=dilation, padding=get_padding(k, dilation))
    if std is not None:  # the reference's init_weights: normal(0, 0.01)
        nn.init.normal_(conv.weight, std=std)
    return conv


class ResBlock1(nn.Module):
    """Two-conv residual units at dilations (1, 3, 5)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([_conv(channels, channels, kernel_size, d) for d in dilations])
        self.convs2 = nn.ModuleList([_conv(channels, channels, kernel_size) for _ in dilations])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(leaky_relu(c1(leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
        return x


class ResBlock2(nn.Module):
    """Single-conv residual units at dilations (1, 3)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList([_conv(channels, channels, kernel_size, d) for d in dilations])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = x + c(leaky_relu(x, LRELU_SLOPE))
        return x


class HifiGanGenerator(nn.Module):
    """mel ``[B, in_channels, T]`` -> waveform ``[B, T*prod(upsample_rates)]``."""

    def __init__(self, in_channels: int = 80, upsample_initial_channel: int = 512,
                 upsample_rates: Sequence[int] = (5, 4, 4, 4),
                 upsample_kernel_sizes: Sequence[int] = (9, 8, 8, 8), resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 use_weight_norm: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.num_kernels = len(resblock_kernel_sizes)
        self.conv_pre = _conv(in_channels, upsample_initial_channel, 7, std=None)
        res_cls = ResBlock1 if str(resblock) == "1" else ResBlock2
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            up = nn.ConvTranspose1d(2 * ch, ch, k, u, padding=(k - u) // 2)
            nn.init.normal_(up.weight, std=0.01)
            self.ups.append(up)
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(res_cls(ch, rk, tuple(rd)))
        self.conv_post = _conv(ch, 1, 7)
        if use_weight_norm:
            apply_weight_norm(self)

    def upsample_stage(self, i: int, x: torch.Tensor,
                       source: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Stage ``i``: leaky ReLU, upsample, ``+ source`` (NSF's excitation,
        cut to x's length) and the mean of the stage's residual blocks."""
        x = self.ups[i](leaky_relu(x, LRELU_SLOPE))
        if source is not None:
            x = x + source[..., : x.shape[-1]]
        K = self.num_kernels
        acc = self.resblocks[i * K](x)
        for j in range(1, K):
            acc = acc + self.resblocks[i * K + j](x)
        return acc / K

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.to(self.conv_pre.bias.dtype))
        for i in range(len(self.ups)):
            x = self.upsample_stage(i, x)
        return torch.tanh(self.conv_post(leaky_relu(x, 0.01)))[:, 0]


def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``[n_in, n_out]`` weights of ``jax.image.resize(..., "linear")`` along
    one axis. Growing, it is ``F.interpolate(mode="linear",
    align_corners=False)``; shrinking, the triangle kernel widens by
    ``n_in / n_out`` (JAX antialiases, ``F.interpolate`` does not)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


class CodeUpsampleHifiGanGenerator(nn.Module):
    """Codec tokens ``[B, Q, T]`` -> waveform (``hifigan.py:155-195``): one
    embedding table over all codebooks (ids offset by ``code_num`` per
    codebook, clamped to the pad id), the Q embeddings concatenated per
    frame, resized in time by ``unit_upsample_rate`` as ``jax.image.resize``
    does, then the HiFi-GAN stack (``generator``). Names follow the JAX
    package's module (``code_embed``, ``generator.*``)."""

    def __init__(self, code_num: int = 1024, codebook_num: int = 3, code_emb_dim: int = 128,
                 unit_upsample_rate: float = 1.0, upsample_initial_channel: int = 512,
                 upsample_rates: Sequence[int] = (5, 4, 4, 4),
                 upsample_kernel_sizes: Sequence[int] = (9, 8, 8, 8), resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 use_weight_norm: bool = False):
        super().__init__()
        self.code_num, self.codebook_num = code_num, codebook_num
        self.unit_upsample_rate = unit_upsample_rate
        self.code_embed = nn.Embedding(code_num * codebook_num + 5, code_emb_dim)
        self.generator = HifiGanGenerator(
            codebook_num * code_emb_dim, upsample_initial_channel, upsample_rates,
            upsample_kernel_sizes, resblock, resblock_kernel_sizes, resblock_dilation_sizes,
            use_weight_norm)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        B, Q, T = codes.shape
        if Q != self.codebook_num:
            raise ValueError(f"{Q} codebooks, expected {self.codebook_num}")
        pad_id = self.code_num * self.codebook_num
        offsets = self.code_num * torch.arange(Q, device=codes.device, dtype=codes.dtype)
        ids = torch.clamp_max(codes + offsets[None, :, None], pad_id).long()
        x = self.code_embed(ids).transpose(1, 2).reshape(B, T, -1)  # [B, T, Q*e]
        if self.unit_upsample_rate != 1.0:
            resize = torch.from_numpy(linear_resize_matrix(
                T, int(T * self.unit_upsample_rate))).to(x.device, x.dtype)
            x = torch.einsum("btc,to->boc", x, resize)
        return self.generator(x.transpose(1, 2))


_CONFIG_KEYS = [("audio_num_mel_bins", "in_channels"),
                ("upsample_initial_channel", "upsample_initial_channel"),
                ("upsample_rates", "upsample_rates"),
                ("upsample_kernel_sizes", "upsample_kernel_sizes"),
                ("resblock", "resblock"),
                ("resblock_kernel_sizes", "resblock_kernel_sizes"),
                ("resblock_dilation_sizes", "resblock_dilation_sizes")]


def load_generator_state_dict(path: str) -> dict:
    """A generator state_dict from a reference checkpoint (``state_dict`` ->
    ``model_gen``; ``generator``; ``model`` -> ``generator``; weight norm
    folded) or from the port's own ``torch.save``."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "model_gen", "generator"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    return fold_torch_weight_norm(obj)


class HifiGAN:
    """Runtime wrapper: ``HifiGAN(ckpt_dir)(mel) -> np.ndarray`` waveform.

    ``vocoder_ckpt`` is a directory with an optional ``config.yaml`` and a
    generator checkpoint (``model_gen.pt``, ``generator.pt``, the JAX
    package's ``model_gen.npz`` or ``generator.npz``, or the reference's
    ``model_ckpt_steps_*.ckpt``, the largest step), so one directory serves
    both packages' CLIs. Without one the generator keeps a random init made
    from ``seed``.
    """

    def __init__(self, vocoder_ckpt: Optional[str] = None, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0, **config_overrides):
        from versband_tpu_torch.utils.config import load_config

        self.device = resolve_device(device)
        cfg = {}
        if vocoder_ckpt and os.path.exists(os.path.join(vocoder_ckpt, "config.yaml")):
            cfg = dict(load_config(os.path.join(vocoder_ckpt, "config.yaml")))
        cfg.update(config_overrides)
        kw = {dst: cfg[src] for src, dst in _CONFIG_KEYS if src in cfg}
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = HifiGanGenerator(**kw)
        path = self._find_ckpt(vocoder_ckpt) if vocoder_ckpt else None
        if path is not None and path.endswith(".npz"):
            from versband_tpu_torch.utils.checkpoint import load_npz_params
            from versband_tpu_torch.utils.convert import state_dict_from_jax

            # flax weight norm (kernel_v, kernel_g) is folded as JAX folds it
            self.model.load_state_dict(state_dict_from_jax(load_npz_params(path), "hifigan"))
        elif path is not None:
            self.model.load_state_dict(load_generator_state_dict(path))
        self.model.to(device=self.device, dtype=dtype).eval()

    @staticmethod
    def _find_ckpt(ckpt_dir: str) -> Optional[str]:
        for name in ("model_gen.pt", "generator.pt", "model_gen.npz", "generator.npz"):
            path = os.path.join(ckpt_dir, name)
            if os.path.exists(path):
                return path
        return get_last_checkpoint(ckpt_dir, kind="hifigan")[0]

    @torch.no_grad()
    def waveform(self, mel: torch.Tensor) -> torch.Tensor:
        """mel ``[B, in_channels, T]`` on the wrapper's device -> ``[B, T*hop]``
        there, queued without waiting."""
        return self.model(mel)

    def spec2wav(self, mel) -> np.ndarray:
        mel = torch.as_tensor(np.asarray(mel) if not torch.is_tensor(mel) else mel)
        if mel.ndim == 2:
            mel = mel[None]
        if mel.shape[1] != self.model.in_channels:
            mel = mel.transpose(1, 2)
        return self.waveform(mel.to(self.device)).float().cpu().numpy().reshape(-1)

    def vocode(self, mel) -> np.ndarray:
        if np.ndim(mel) != 2:
            raise ValueError("vocode takes one mel [n_mels, T]")
        return self.spec2wav(mel)

    def __call__(self, mel) -> np.ndarray:
        return self.spec2wav(mel)
