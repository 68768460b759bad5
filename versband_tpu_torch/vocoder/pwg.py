"""ParallelWaveGAN, MelGAN and PQMF (port of ``versband_tpu/vocoder/pwg.py``).

``ParallelWaveGANGenerator`` maps (noise ``[B, 1, T]``, mel ``[B, 80, T']``)
to a waveform ``[B, 1, T]`` through 30 gated WaveNet residual layers over the
noise, conditioned on the upsampled mel
(``parallel_wavegan/models/parallel_wavegan.py:21-205``). With
``fused_inference`` each layer is one call of ``fused_wavenet_layer`` (K5 on
the card, its plain version on the CPU), an fp32 skip accumulator threaded
through the layers; otherwise the dense layers run as the reference's.
``use_weight_norm=True`` builds the trainable form (every ``Conv1d`` as
(``weight_v``, ``weight_g``) in the JAX package's convention,
``vocoder/conv.py``; the upsampler's stencils stay plain, as in JAX), which
``train/vocoder_step.py`` trains unfused; ``use_pitch_embed`` adds the
pitch embedding (``Embed(300)``, concatenated, ``c_proj``). While the
program's spans are on (``utils/profiling.py``) the generator's forward
records ``vocoder.pwg.upsample`` (pitch embedding and mel upsampler),
``vocoder.pwg.wavenet`` (the skip accumulator and the residual layers) and
the counter ``vocoder.pwg.samples`` (B x T a call).

Parameter names are the reference's: ``first_conv``;
``upsample_net.conv_in``; ``upsample_net.upsample.up_layers.{2j+1}`` (the
``Conv2d [1, 1, fk, 2s+1]`` after each nearest ``Stretch2d``);
``conv_layers.{i}.{conv,conv1x1_aux,conv1x1_skip,conv1x1_out}``;
``last_conv_layers.{1,3}``. The mel upsampler is the reference's
nearest-stretch + ``(fk, 2s+1)`` conv, which computes the same function as
the JAX package's 3-tap phase form.

Also here: ``ParallelWaveGANDiscriminator`` (``conv_layers.{2i}``),
``MelGANGenerator`` (the reference's flat ``melgan`` sequence, with
``ResidualStack``'s ``stack.{2,4}`` and ``skip_layer``),
``MelGANDiscriminator`` / ``MelGANMultiScaleDiscriminator``
(``discriminators.{i}.layers.{n}``) and ``PQMF``. Two MelGAN choices follow
the JAX package, not upstream (ROADMAP Queue 3): a discriminator's first conv
pads with zeros (upstream reflects), and the multi-scale pool counts its
padding (upstream ``count_include_pad=False``).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from versband_tpu_torch.device import DeviceLike, resolve_device
from versband_tpu_torch.dsp.mel import reflect_pad
from versband_tpu_torch.ops.fused_wavenet import PackCache, fused_wavenet_layer
from versband_tpu_torch.utils.checkpoint import get_last_checkpoint
from versband_tpu_torch.utils.profiling import annotate, count
from versband_tpu_torch.vocoder.conv import apply_weight_norm
from versband_tpu_torch.vocoder.hifigan import load_generator_state_dict


class ResidualBlock(nn.Module):
    """Gated WaveNet residual block (``layers/residual_block.py:39-130``):
    dilated conv -> split -> (+ aux 1x1) -> tanh * sigmoid -> skip and
    residual 1x1s."""

    def __init__(self, kernel_size: int = 3, residual_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64, aux_channels: int = 80,
                 dilation: int = 1, use_bias: bool = True):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        self.conv = nn.Conv1d(residual_channels, gate_channels, kernel_size,
                              padding=(kernel_size - 1) // 2 * dilation, dilation=dilation,
                              bias=use_bias)
        self.conv1x1_aux = nn.Conv1d(aux_channels, gate_channels, 1, bias=False)
        self.conv1x1_out = nn.Conv1d(gate_channels // 2, residual_channels, 1, bias=use_bias)
        self.conv1x1_skip = nn.Conv1d(gate_channels // 2, skip_channels, 1, bias=use_bias)
        self._k5_pack = PackCache()  # K5's packed weights, remade when a weight changes

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor],
                skip: Optional[torch.Tensor] = None):
        """Returns ``(x', s)``. When ``skip`` (the fp32 ``[B, S, T]``
        accumulator) and ``c`` are given and the kernel is 3 taps, the layer
        is one ``fused_wavenet_layer`` call and ``s`` is ``skip + new skip``;
        otherwise the dense path runs and ``s`` is this layer's skip alone
        (or ``skip + s`` in skip's type when ``skip`` is given)."""
        if skip is not None and c is not None and self.kernel_size == 3:
            return fused_wavenet_layer(
                x, c, skip, self.conv.weight, self.conv.bias, self.conv1x1_aux.weight,
                self.conv1x1_skip.weight, self.conv1x1_skip.bias, self.conv1x1_out.weight,
                self.conv1x1_out.bias, self.dilation, self._k5_pack)
        h = self.conv(x)
        xa, xb = h.chunk(2, dim=1)
        if c is not None:
            ca, cb = self.conv1x1_aux(c).chunk(2, dim=1)
            xa, xb = xa + ca, xb + cb
        z = torch.tanh(xa) * torch.sigmoid(xb)
        s = self.conv1x1_skip(z)
        out = (self.conv1x1_out(z) + x) * math.sqrt(0.5)
        return (out, skip + s.to(skip.dtype)) if skip is not None else (out, s)


class Stretch2d(nn.Module):
    """Nearest-neighbour stretch of the last axis by ``scale``."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return torch.repeat_interleave(c, self.scale, dim=-1)


class UpsampleNetwork(nn.Module):
    """Nearest stretch + ``(fk, 2s+1)`` smoothing conv per scale
    (``layers/upsample.py:61-123``). ``[B, C, T] -> [B, C, T * prod(scales)]``."""

    def __init__(self, upsample_scales: Sequence[int], freq_axis_kernel_size: int = 1):
        super().__init__()
        self.up_layers = nn.ModuleList()
        fk = freq_axis_kernel_size
        for scale in upsample_scales:
            conv = nn.Conv2d(1, 1, (fk, 2 * scale + 1), padding=((fk - 1) // 2, scale),
                             bias=False)
            nn.init.constant_(conv.weight, 1.0 / (fk * (2 * scale + 1)))  # upsample.py:47-58
            self.up_layers.extend([Stretch2d(scale), conv])

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        c = c.unsqueeze(1)
        for f in self.up_layers:
            c = f(c)
        return c.squeeze(1)


class ConvInUpsampleNetwork(nn.Module):
    """Context conv (kernel 2w+1, no padding, no bias) + ``UpsampleNetwork``
    (``layers/upsample.py:125-175``). ``[B, C, T' + 2w] -> [B, C, T' * hop]``."""

    def __init__(self, upsample_scales: Sequence[int], aux_channels: int = 80,
                 aux_context_window: int = 2, freq_axis_kernel_size: int = 1):
        super().__init__()
        self.conv_in = nn.Conv1d(aux_channels, aux_channels, 2 * aux_context_window + 1,
                                 bias=False)
        self.upsample = UpsampleNetwork(upsample_scales, freq_axis_kernel_size)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.upsample(self.conv_in(c))


class ParallelWaveGANGenerator(nn.Module):
    """(noise ``[B, 1, T]``, mel ``[B, aux, T' + 2w]``) -> wav ``[B, 1, T]``."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, kernel_size: int = 3,
                 layers: int = 30, stacks: int = 3, residual_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64, aux_channels: int = 80,
                 aux_context_window: int = 2, upsample_scales: Sequence[int] = (4, 4, 4, 5),
                 use_upsample: bool = True, use_pitch_embed: bool = False,
                 use_weight_norm: bool = False, fused_inference: bool = False):
        super().__init__()
        self.kernel_size, self.layers = kernel_size, layers
        self.skip_channels, self.aux_channels = skip_channels, aux_channels
        self.aux_context_window = aux_context_window
        self.upsample_scales = tuple(upsample_scales)
        self.fused_inference = fused_inference
        self.first_conv = nn.Conv1d(in_channels, residual_channels, 1)
        self.upsample_net = ConvInUpsampleNetwork(upsample_scales, aux_channels,
                                                  aux_context_window) if use_upsample else None
        per_stack = layers // stacks
        self.conv_layers = nn.ModuleList([
            ResidualBlock(kernel_size, residual_channels, gate_channels, skip_channels,
                          aux_channels, 2 ** (i % per_stack)) for i in range(layers)])
        self.last_conv_layers = nn.ModuleList([
            nn.ReLU(), nn.Conv1d(skip_channels, skip_channels, 1), nn.ReLU(),
            nn.Conv1d(skip_channels, out_channels, 1)])
        if use_pitch_embed:
            self.pitch_embed = nn.Embedding(300, aux_channels)
            self.c_proj = nn.Linear(2 * aux_channels, aux_channels)
        self.use_pitch_embed = use_pitch_embed
        if use_weight_norm:
            apply_weight_norm(self, types=(nn.Conv1d,))

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None,
                pitch: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.first_conv.bias.dtype
        x = x.to(dtype)
        if c is not None:
            c = c.to(dtype)
            with annotate("vocoder.pwg.upsample"):
                if self.use_pitch_embed and pitch is not None:  # pitch [B, T'] ids < 300
                    c = self.c_proj(torch.cat([c.transpose(1, 2),
                                               self.pitch_embed(pitch.long())],
                                              dim=-1)).transpose(1, 2)
                if self.upsample_net is not None:
                    c = self.upsample_net(c)
            if c.shape[-1] != x.shape[-1]:
                raise ValueError(f"aux length {c.shape[-1]} != noise length {x.shape[-1]}")
        h = self.first_conv(x)
        count("vocoder.pwg.samples", x.shape[0] * x.shape[-1])
        fused = self.fused_inference and c is not None and self.kernel_size == 3
        with annotate("vocoder.pwg.wavenet"):
            if fused:  # fp32 skip accumulator threaded through K5
                skips = torch.zeros(h.shape[0], self.skip_channels, h.shape[-1],
                                    dtype=torch.float32, device=h.device)
                c = c.contiguous()
                for layer in self.conv_layers:
                    h, skips = layer(h, c, skip=skips)
                skips = skips.to(dtype)
            else:
                skips = 0.0
                for layer in self.conv_layers:
                    h, s = layer(h, c)
                    skips = skips + s
        z = skips * math.sqrt(1.0 / self.layers)
        for f in self.last_conv_layers:
            z = f(z)
        return z

    @staticmethod
    def receptive_field_size(layers: int = 30, stacks: int = 3, kernel_size: int = 3) -> int:
        """Samples one output sample sees: (k - 1) * sum of the dilations + 1."""
        per_stack = layers // stacks
        return (kernel_size - 1) * sum(2 ** (i % per_stack) for i in range(layers)) + 1


class ParallelWaveGAN:
    """Runtime wrapper serving ``vocode(mel)`` like ``HifiGAN`` and
    ``VocoderBigVGAN``. The mel is edge-padded by ``aux_context_window``
    frames per side (consumed by the unpadded ``conv_in``), so the waveform
    covers all T' frames (T' x hop samples); the WaveNet input is standard
    normal noise drawn from a ``torch.Generator`` on the wrapper's device,
    seeded from ``seed`` (torch draws, not the JAX package's). Weights: a
    directory with a generator checkpoint in the reference's names
    (``model_gen.pt``, ``generator.pt`` or the parallel_wavegan library's
    ``checkpoint-*steps.pkl`` of the largest step, whose ``model ->
    generator`` is read; torch weight norm folded), or none (random init from
    ``seed``). K5 serves by default (``fused_inference=True``).
    """

    def __init__(self, vocoder_ckpt: Optional[str] = None, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32, fused_inference: bool = True,
                 seed: int = 0, **overrides):
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = ParallelWaveGANGenerator(fused_inference=fused_inference, **overrides)
        self.hop = int(np.prod(self.model.upsample_scales))
        path = self._find_ckpt(vocoder_ckpt) if vocoder_ckpt else None
        if path is not None:
            self.model.load_state_dict(load_generator_state_dict(path))
        self.model.to(device=self.device, dtype=dtype).eval()
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @staticmethod
    def _find_ckpt(ckpt_dir: str) -> Optional[str]:
        for name in ("model_gen.pt", "generator.pt"):
            path = os.path.join(ckpt_dir, name)
            if os.path.exists(path):
                return path
        return get_last_checkpoint(ckpt_dir, kind="pwg")[0]

    @torch.no_grad()
    def waveform(self, mel: torch.Tensor) -> torch.Tensor:
        """mel ``[B, aux, T']`` on the wrapper's device -> ``[B, T' * hop]``
        there, queued without waiting; draws the noise."""
        with annotate("vocoder.waveform"):
            w = self.model.aux_context_window
            mel = F.pad(mel.to(self.dtype), (w, w), mode="replicate")
            noise = torch.randn((mel.shape[0], 1, (mel.shape[-1] - 2 * w) * self.hop),
                                generator=self.generator, device=self.device, dtype=self.dtype)
            return self.model(noise, mel)[:, 0]

    def spec2wav(self, mel) -> np.ndarray:
        mel = torch.as_tensor(np.asarray(mel) if not torch.is_tensor(mel) else mel)
        if mel.ndim == 2:
            mel = mel[None]
        if mel.shape[1] != self.model.aux_channels:
            mel = mel.transpose(1, 2)
        return self.waveform(mel.to(self.device)).float().cpu().numpy().reshape(-1)

    def vocode(self, mel) -> np.ndarray:
        if np.ndim(mel) != 2:
            raise ValueError("vocode takes one mel [n_mels, T]")
        return self.spec2wav(mel)

    def __call__(self, mel) -> np.ndarray:
        return self.spec2wav(mel)


class ParallelWaveGANDiscriminator(nn.Module):
    """Dilated non-causal conv stack (``models/parallel_wavegan.py:207-300``):
    ``layers - 1`` convs at dilations 1, 1, 2, 3, ... (or
    ``dilation_factor ** i``), each followed by LeakyReLU, then the output
    conv. wav ``[B, 1, T]`` -> ``[B, 1, T]``."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, kernel_size: int = 3,
                 layers: int = 10, conv_channels: int = 64, dilation_factor: int = 1,
                 negative_slope: float = 0.2, use_weight_norm: bool = True):
        super().__init__()
        mods, cin = [], in_channels
        for i in range(layers - 1):
            d = max(i if dilation_factor == 1 else dilation_factor ** i, 1)
            mods += [nn.Conv1d(cin, conv_channels, kernel_size, dilation=d,
                               padding=(kernel_size - 1) // 2 * d),
                     nn.LeakyReLU(negative_slope)]
            cin = conv_channels
        mods.append(nn.Conv1d(cin, out_channels, kernel_size, padding=(kernel_size - 1) // 2))
        self.conv_layers = nn.ModuleList(mods)
        if use_weight_norm:
            apply_weight_norm(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for f in self.conv_layers:
            x = f(x)
        return x


class ReflectPad1d(nn.Module):
    """``nn.ReflectionPad1d`` with ``jnp.pad``'s folding past the signal's
    edge (:func:`reflect_pad`), where torch's pad raises on a pad as long as
    the signal."""

    def __init__(self, pad: int):
        super().__init__()
        self.pad = pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reflect_pad(x, self.pad, self.pad)


class ResidualStack(nn.Module):
    """MelGAN residual stack (``layers/residual_stack.py``): ``stack`` =
    LeakyReLU, reflect pad, dilated conv, LeakyReLU, 1x1; plus a 1x1
    ``skip_layer`` shortcut."""

    def __init__(self, kernel_size: int = 3, channels: int = 32, dilation: int = 1,
                 negative_slope: float = 0.2):
        super().__init__()
        self.stack = nn.Sequential(
            nn.LeakyReLU(negative_slope),
            ReflectPad1d((kernel_size - 1) // 2 * dilation),
            nn.Conv1d(channels, channels, kernel_size, dilation=dilation),
            nn.LeakyReLU(negative_slope),
            nn.Conv1d(channels, channels, 1))
        self.skip_layer = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stack(x) + self.skip_layer(x)


class MelGANGenerator(nn.Module):
    """mel ``[B, 80, T']`` -> wav ``[B, out, T' * prod(scales)]``
    (``models/melgan.py:18-192``), as the reference's flat ``melgan``
    sequence: reflect pad + conv, per scale LeakyReLU + transposed conv +
    ``stacks`` residual stacks (dilations k^j), LeakyReLU, reflect pad +
    conv, tanh."""

    def __init__(self, in_channels: int = 80, out_channels: int = 1, kernel_size: int = 7,
                 channels: int = 512, upsample_scales: Sequence[int] = (8, 8, 5),
                 stack_kernel_size: int = 3, stacks: int = 3, negative_slope: float = 0.2,
                 use_final_nonlinear_activation: bool = True, use_weight_norm: bool = True):
        super().__init__()
        pad = (kernel_size - 1) // 2
        layers = [ReflectPad1d(pad), nn.Conv1d(in_channels, channels, kernel_size)]
        cin = channels
        for i, scale in enumerate(upsample_scales):
            ch = channels // 2 ** (i + 1)
            layers += [nn.LeakyReLU(negative_slope),
                       nn.ConvTranspose1d(cin, ch, scale * 2, scale,
                                          padding=scale // 2 + scale % 2,
                                          output_padding=scale % 2)]
            layers += [ResidualStack(stack_kernel_size, ch, stack_kernel_size ** j,
                                     negative_slope) for j in range(stacks)]
            cin = ch
        layers += [nn.LeakyReLU(negative_slope), ReflectPad1d(pad),
                   nn.Conv1d(cin, out_channels, kernel_size)]
        if use_final_nonlinear_activation:
            layers.append(nn.Tanh())
        self.melgan = nn.Sequential(*layers)
        if use_weight_norm:
            apply_weight_norm(self)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.melgan(c)


class MelGANDiscriminator(nn.Module):
    """One MelGAN discriminator (``models/melgan.py:194-300``); returns every
    layer's output, the last being the score. The first conv pads with zeros
    (the JAX package; upstream reflects); groups of a downsampling conv are
    ``max(in_channels // 4, 1)``."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_sizes: Sequence[int] = (5, 3), channels: int = 16,
                 max_downsample_channels: int = 1024,
                 downsample_scales: Sequence[int] = (4, 4, 4, 4), negative_slope: float = 0.2):
        super().__init__()
        k0 = int(np.prod(kernel_sizes))
        act = nn.LeakyReLU(negative_slope)
        layers = [nn.Sequential(nn.ConstantPad1d((k0 - 1) // 2, 0.0),
                                nn.Conv1d(in_channels, channels, k0), act)]
        ch = channels
        for scale in downsample_scales:
            out = min(ch * scale, max_downsample_channels)
            layers.append(nn.Sequential(
                nn.Conv1d(ch, out, scale * 10 + 1, scale, padding=scale * 5,
                          groups=max(ch // 4, 1)), act))
            ch = out
        out = min(ch * 2, max_downsample_channels)
        layers.append(nn.Sequential(nn.Conv1d(ch, out, kernel_sizes[0],
                                              padding=(kernel_sizes[0] - 1) // 2), act))
        layers.append(nn.Conv1d(out, out_channels, kernel_sizes[1],
                                padding=(kernel_sizes[1] - 1) // 2))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for f in self.layers:
            x = f(x)
            outs.append(x)
        return outs


class MelGANMultiScaleDiscriminator(nn.Module):
    """``scales`` MelGAN discriminators, average pools of 4 / 2 (padding 1,
    counted in the mean, as the JAX package pools) between them
    (``models/melgan.py:303-399``)."""

    def __init__(self, scales: int = 3, use_weight_norm: bool = True, **disc_kwargs):
        super().__init__()
        self.discriminators = nn.ModuleList([MelGANDiscriminator(**disc_kwargs)
                                             for _ in range(scales)])
        self.pooling = nn.AvgPool1d(4, 2, padding=1)
        if use_weight_norm:
            apply_weight_norm(self)

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        outs = []
        for d in self.discriminators:
            outs.append(d(x))
            x = self.pooling(x)
        return outs


def design_prototype_filter(taps: int = 62, cutoff_ratio: float = 0.15,
                            beta: float = 9.0) -> np.ndarray:
    """Kaiser-window prototype low-pass (``layers/pqmf.py:16-49``)."""
    if taps % 2:
        raise ValueError("taps must be even")
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = cutoff_ratio
    return h_i * np.kaiser(taps + 1, beta)


class PQMF(nn.Module):
    """Near-perfect-reconstruction pseudo-QMF bank (``layers/pqmf.py:51-129``).

    No parameters: the cos-modulated filters are buffers kept out of the
    state_dict. Analysis is the filter bank and the stride-M decimation as one
    strided conv; synthesis zero-stuffs by M (gain M) and filters."""

    def __init__(self, subbands: int = 4, taps: int = 62, cutoff_ratio: float = 0.15,
                 beta: float = 9.0):
        super().__init__()
        h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
        n = np.arange(taps + 1)
        h_analysis = np.zeros((subbands, taps + 1))
        h_synthesis = np.zeros((subbands, taps + 1))
        for k in range(subbands):
            phase = (2 * k + 1) * (np.pi / (2 * subbands)) * (n - (taps - 1) / 2)
            h_analysis[k] = 2 * h_proto * np.cos(phase + (-1) ** k * np.pi / 4)
            h_synthesis[k] = 2 * h_proto * np.cos(phase - (-1) ** k * np.pi / 4)
        self.subbands, self.taps = subbands, taps
        self.register_buffer("analysis_filter", torch.from_numpy(
            h_analysis[:, None, :].astype(np.float32)), persistent=False)   # [M, 1, taps+1]
        self.register_buffer("synthesis_filter", torch.from_numpy(
            h_synthesis[None].astype(np.float32)), persistent=False)        # [1, M, taps+1]

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, 1, T]`` -> ``[B, M, T // M]``."""
        p = self.taps // 2
        return F.conv1d(F.pad(x, (p, p)), self.analysis_filter.to(x.dtype),
                        stride=self.subbands)

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, M, T // M]`` -> ``[B, 1, T]``."""
        M = self.subbands
        B, _, Tm = x.shape
        up = x.new_zeros(B, M, Tm * M)
        up[:, :, ::M] = x * M
        p = self.taps // 2
        return F.conv1d(F.pad(up, (p, p)), self.synthesis_filter.to(x.dtype))
