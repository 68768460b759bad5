"""BigVGAN vocoder (port of ``versband_tpu/vocoder/bigvgan.py``).

``BigVGANGenerator`` maps a mel ``[B, 80, T]`` to a waveform ``[B, T*hop]``
with AMP residual blocks whose activations are the alias-free Snake(Beta)
``Activation1d``: with ``use_fused`` (the default) one launch of K4
(``ops/fused_act1d.py``) per activation on the card; without it, the
unfused ``UpSample1d -> snake -> DownSample1d`` modules on either device, as
the JAX package runs them for training. ``use_weight_norm=True`` builds the
trainable form (every conv as (``weight_v``, ``weight_g``) in the JAX
package's convention, ``vocoder/conv.py``); with ``use_fused=False`` it is
what ``train/vocoder_step.py`` trains. Defaults are the 24 kHz / hop-320
generator: 512 initial channels, rates (5, 4, 4, 4), upsample kernels
(9, 8, 8, 8), ``resblock "1"`` with kernels (3, 7, 11) at dilations
(1, 3, 5), SnakeBeta with ``logscale``. While the program's spans are on
(``utils/profiling.py``) the generator's forward records
``vocoder.bigvgan.upsample`` around each stage's transposed convolution,
``vocoder.bigvgan.amp`` around each stage's AMP blocks and their mean, and
the counter ``vocoder.bigvgan.samples`` (the output's B x T); each
``Activation1d`` records ``vocoder.bigvgan.act`` (fused or not) and adds its
input's B x C x T to the counter ``vocoder.bigvgan.act_samples``.

Parameter names are the reference's (``vocoder/bigvgan/models.py``):
``conv_pre``, ``ups.{i}.0`` (each upsampler in a one-element
``ModuleList``), ``resblocks.{i*K+j}.convs1/convs2.{n}`` (``convs.{n}`` for
AMPBlock2), ``resblocks.{...}.activations.{m}.act.{alpha,beta}``,
``activation_post.act.*`` and ``conv_post``. The kaiser-sinc taps are
constants of ``ops/fused_act1d.py``, not buffers: they are not in the
state_dict, and the reference's ``*.filter`` buffers are dropped on load
(:func:`drop_filter_buffers`). The TPU-only polyphase path
(``alias_free_snake_polyphase``, ``_edge_fix``) is not ported: it computes
the same function as the unfused modules.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from versband_tpu_torch.device import DeviceLike, resolve_device
from versband_tpu_torch.ops.fused_act1d import (downsample1d, fused_alias_free_snake,
                                                kaiser_sinc_filter1d, snake, upsample1d)
from versband_tpu_torch.utils.checkpoint import get_last_checkpoint
from versband_tpu_torch.utils.profiling import annotate, count
from versband_tpu_torch.vocoder.conv import apply_weight_norm
from versband_tpu_torch.vocoder.hifigan import _conv, load_generator_state_dict

__all__ = ["kaiser_sinc_filter1d", "snake", "UpSample1d", "DownSample1d", "Activation1d",
           "AMPBlock1", "AMPBlock2", "BigVGANGenerator", "VocoderBigVGAN",
           "drop_filter_buffers"]


class UpSample1d(nn.Module):
    """ratio-x kaiser-sinc upsample (``resample.py:10-33``)."""

    def __init__(self, ratio: int = 2, kernel_size: Optional[int] = None):
        super().__init__()
        self.ratio, self.kernel_size = ratio, kernel_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample1d(x, self.ratio, self.kernel_size)


class DownSample1d(nn.Module):
    """ratio-x kaiser-sinc low-pass and decimate (``resample.py:36-49``)."""

    def __init__(self, ratio: int = 2, kernel_size: Optional[int] = None):
        super().__init__()
        self.ratio, self.kernel_size = ratio, kernel_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return downsample1d(x, self.ratio, self.kernel_size)


class Snake(nn.Module):
    """Per-channel Snake (``beta is None``) or SnakeBeta parameters; init 0
    with ``logscale`` (exp(0) = 1), else 1 (``activations.py``)."""

    def __init__(self, channels: int, variant: str = "snakebeta", logscale: bool = True):
        super().__init__()
        if variant not in ("snake", "snakebeta"):
            raise ValueError(f"unknown activation {variant!r}; expected snake or snakebeta")
        init = torch.zeros if logscale else torch.ones
        self.logscale = logscale
        self.alpha = nn.Parameter(init(channels))
        self.beta = nn.Parameter(init(channels)) if variant == "snakebeta" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha, self.beta, self.logscale)


class Activation1d(nn.Module):
    """2x upsample -> Snake(Beta) -> 2x downsample (``alias_free_torch/act.py``).

    ``use_fused``: one call of ``fused_alias_free_snake`` (K4 on the card, its
    plain version on the CPU); otherwise the unfused modules in x's type.
    """

    def __init__(self, channels: int, variant: str = "snakebeta", logscale: bool = True,
                 use_fused: bool = True):
        super().__init__()
        self.use_fused = use_fused
        self.act = Snake(channels, variant, logscale)
        self.upsample = UpSample1d(2)
        self.downsample = DownSample1d(2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        count("vocoder.bigvgan.act_samples", x.numel())
        with annotate("vocoder.bigvgan.act"):
            if self.use_fused:
                return fused_alias_free_snake(x, self.act.alpha, self.act.beta,
                                              self.act.logscale)
            return self.downsample(self.act(self.upsample(x)))


class AMPBlock1(nn.Module):
    """3x (act-conv-act-conv) residual units at dilations (1, 3, 5)
    (``models.py:30-88``); ``activations.{2n}``/``{2n+1}`` precede
    ``convs1.{n}``/``convs2.{n}``."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 5),
                 activation: str = "snakebeta", snake_logscale: bool = True,
                 use_fused: bool = True):
        super().__init__()
        self.convs1 = nn.ModuleList([_conv(channels, channels, kernel_size, d) for d in dilations])
        self.convs2 = nn.ModuleList([_conv(channels, channels, kernel_size) for _ in dilations])
        self.activations = nn.ModuleList([
            Activation1d(channels, activation, snake_logscale, use_fused)
            for _ in range(2 * len(dilations))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for n, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            x = x + c2(self.activations[2 * n + 1](c1(self.activations[2 * n](x))))
        return x


class AMPBlock2(nn.Module):
    """2x (act-conv) residual units at dilations (1, 3) (``models.py:91-131``)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3),
                 activation: str = "snakebeta", snake_logscale: bool = True,
                 use_fused: bool = True):
        super().__init__()
        self.convs = nn.ModuleList([_conv(channels, channels, kernel_size, d) for d in dilations])
        self.activations = nn.ModuleList([
            Activation1d(channels, activation, snake_logscale, use_fused) for _ in dilations])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, act in zip(self.convs, self.activations):
            x = x + conv(act(x))
        return x


class BigVGANGenerator(nn.Module):
    """mel ``[B, num_mels, T]`` -> waveform ``[B, T*prod(upsample_rates)]``
    (``models.py:133-205``)."""

    def __init__(self, num_mels: int = 80, upsample_initial_channel: int = 512,
                 upsample_rates: Sequence[int] = (5, 4, 4, 4),
                 upsample_kernel_sizes: Sequence[int] = (9, 8, 8, 8), resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 activation: str = "snakebeta", snake_logscale: bool = True,
                 use_fused: bool = True, use_weight_norm: bool = False):
        super().__init__()
        self.num_mels = num_mels
        self.use_fused = use_fused
        self.num_kernels = len(resblock_kernel_sizes)
        self.conv_pre = _conv(num_mels, upsample_initial_channel, 7, std=None)
        amp_cls = AMPBlock1 if str(resblock) == "1" else AMPBlock2
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            up = nn.ConvTranspose1d(2 * ch, ch, k, u, padding=(k - u) // 2)
            nn.init.normal_(up.weight, std=0.01)
            self.ups.append(nn.ModuleList([up]))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(amp_cls(ch, rk, tuple(rd), activation, snake_logscale,
                                              use_fused))
        self.activation_post = Activation1d(ch, activation, snake_logscale, use_fused)
        self.conv_post = _conv(ch, 1, 7)
        if use_weight_norm:
            apply_weight_norm(self)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.to(self.conv_pre.bias.dtype))
        K = self.num_kernels
        for i, up in enumerate(self.ups):
            with annotate("vocoder.bigvgan.upsample"):
                x = up[0](x)
            with annotate("vocoder.bigvgan.amp"):
                acc = self.resblocks[i * K](x)
                for j in range(1, K):
                    acc = acc + self.resblocks[i * K + j](x)
                x = acc / K
        wav = torch.tanh(self.conv_post(self.activation_post(x)))[:, 0]
        count("vocoder.bigvgan.samples", wav.numel())
        return wav


_CONFIG_KEYS = ("num_mels", "upsample_initial_channel", "upsample_rates",
                "upsample_kernel_sizes", "resblock", "resblock_kernel_sizes",
                "resblock_dilation_sizes", "activation", "snake_logscale")


def drop_filter_buffers(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference state_dict without the resamplers' constant ``*.filter``
    buffers (``upsample.filter``, ``downsample.lowpass.filter``)."""
    return {k: v for k, v in sd.items() if not k.endswith(".filter")}


class VocoderBigVGAN:
    """Runtime wrapper (``models.py:393-414``): ``VocoderBigVGAN(ckpt)(mel)``.

    ``ckpt_vocoder`` is a directory with an optional ``args.yml`` (generator
    geometry) and a generator checkpoint (``best_netG.pt``, ``generator.pt``
    or the reference's ``g_*``, the largest step) with the reference's key
    names; torch weight norm is folded and the ``*.filter`` buffers dropped.
    Without one the generator keeps a random init made from ``seed``. The
    generator runs in ``dtype`` (fp32 by default, as in JAX) with K4.
    """

    def __init__(self, ckpt_vocoder: Optional[str] = None, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0, **config_overrides):
        from versband_tpu_torch.utils.config import load_config

        self.device = resolve_device(device)
        cfg = {}
        if ckpt_vocoder and os.path.exists(os.path.join(ckpt_vocoder, "args.yml")):
            cfg = dict(load_config(os.path.join(ckpt_vocoder, "args.yml")))
        cfg.update(config_overrides)
        kw = {k: cfg[k] for k in _CONFIG_KEYS if k in cfg}
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = BigVGANGenerator(**kw)
        path = self._find_ckpt(ckpt_vocoder) if ckpt_vocoder else None
        if path is not None:
            self.model.load_state_dict(drop_filter_buffers(load_generator_state_dict(path)))
        self.model.to(device=self.device, dtype=dtype).eval()

    @staticmethod
    def _find_ckpt(ckpt_dir: str) -> Optional[str]:
        for name in ("best_netG.pt", "generator.pt"):
            path = os.path.join(ckpt_dir, name)
            if os.path.exists(path):
                return path
        return get_last_checkpoint(ckpt_dir, kind="bigvgan")[0]

    @torch.no_grad()
    def waveform(self, mel: torch.Tensor) -> torch.Tensor:
        """mel ``[B, num_mels, T]`` on the wrapper's device -> ``[B, T*hop]``
        there, queued without waiting."""
        with annotate("vocoder.waveform"):
            return self.model(mel)

    def vocode(self, spec) -> np.ndarray:
        spec = torch.as_tensor(np.asarray(spec) if not torch.is_tensor(spec) else spec)
        if spec.ndim == 2:
            spec = spec[None]
        return self.waveform(spec.to(self.device)).float().cpu().numpy().squeeze()

    def __call__(self, spec) -> np.ndarray:
        return self.vocode(spec)
