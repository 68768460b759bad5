"""The discriminators of the vocoder and VAE-GAN recipes (port of
``versband_tpu/vocoder/discriminators.py``).

* HiFi-GAN's ``DiscriminatorP`` / ``MultiPeriodDiscriminator`` (periods 2, 3,
  5, 7, 11) and ``DiscriminatorS`` / ``MultiScaleDiscriminator``
  (``vocoder/hifigan/modules/hifigan.py:198-341``);
* BigVGAN's ``DiscriminatorR`` / ``MultiResolutionDiscriminator`` over STFT
  magnitudes (``vocoder/bigvgan/models.py:277-355``);
* ``MultiWindowDiscriminator``, conv towers over mel clips whose start
  frames the caller passes in;
* the LSGAN loss helpers (``hifigan.py:344-382``);
* the PatchGAN of stage 1's VAE-GAN, ``ActNorm`` and ``NLayerDiscriminator``
  (reference ``ldm/modules/discriminator/model.py``).

Waveforms are ``[B, 1, T]``; feature maps come back channel-first. Each
multi-discriminator's ``forward(y, y_hat)`` returns JAX's four lists
(real scores, generated scores, real maps, generated maps); ``single(x)``
runs one signal. The convs carry weight norm or JAX's stateless spectral
norm (``vocoder/conv.py``). Key names are the reference's
(``discriminators.{i}.convs.{n}``, ``conv_post``; ``weight_v``/``weight_g``,
``weight_orig`` under spectral norm). Two choices follow the JAX package,
not upstream HiFi-GAN (ROADMAP Queue 3): the scale discriminator pools with
``AvgPool1d(4, 2, padding=1)`` (upstream pads by 2), and spectral norm is
stateless (3 power iterations from a fixed start on every call).

A PatchGAN key is the reference's ``nn.Sequential`` ``main``: ``main.0``
the first conv, then per layer n = 1..``n_layers`` the conv ``main.{3n-1}``
and its norm ``main.{3n}``, and the last conv ``main.{3 n_layers + 2}``, so
a reference Lightning checkpoint's ``loss.discriminator.main.*`` loads as it
is. Two of its behaviours follow the JAX package, not the reference
(ROADMAP Queue 3):

* the norm is ``RunningStatsBatchNorm2d``: it normalises by ``running_mean``
  and ``running_var``, which are parameters that the discriminator's
  optimizer trains, never batch statistics. The JAX trainer runs BatchNorm
  with ``use_running_average`` and differentiates its whole variable tree,
  ``batch_stats`` included; the reference runs BatchNorm in training mode;
* ``ActNorm`` starts at loc 0, scale 1 and has no data-dependent init.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from versband_tpu_torch.dsp.mel import reflect_pad
from versband_tpu_torch.vocoder.conv import LRELU_SLOPE, get_padding, spectral_norm, weight_norm
from versband_tpu_torch.vocoder.losses import padded_hann


class RunningStatsBatchNorm2d(nn.Module):
    """``(x - running_mean) * (rsqrt(running_var + eps) * weight) + bias`` per
    channel, as flax's ``BatchNorm(use_running_average=True)`` computes it,
    with all four per-channel vectors trainable parameters (gradients reach
    the statistics, which ``F.batch_norm`` would not pass)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.running_mean = nn.Parameter(torch.zeros(num_features))
        self.running_var = nn.Parameter(torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class ActNorm(nn.Module):
    """``scale * (x + loc)`` per channel, loc 0 and scale 1 at init (the
    reference's shapes ``[1, C, 1, 1]``; no data-dependent init, as in JAX)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, num_features, 1, 1))
        self.scale = nn.Parameter(torch.ones(1, num_features, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * (x + self.loc)


class NLayerDiscriminator(nn.Module):
    """PatchGAN: 4x4 convs with strides 2, 2, ..., 1 and then 1, LeakyReLU
    0.2, a norm after every conv but the first and the last (whose biases it
    replaces under BatchNorm)."""

    def __init__(self, input_nc: int = 1, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False):
        super().__init__()
        kw, padw = 4, 1
        layers = [nn.Conv2d(input_nc, ndf, kw, stride=2, padding=padw), nn.LeakyReLU(0.2)]
        nf_prev = 1
        for n in range(1, n_layers + 1):
            nf = min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            layers += [nn.Conv2d(ndf * nf_prev, ndf * nf, kw, stride=stride, padding=padw,
                                 bias=use_actnorm),
                       ActNorm(ndf * nf) if use_actnorm else RunningStatsBatchNorm2d(ndf * nf),
                       nn.LeakyReLU(0.2)]
            nf_prev = nf
        layers.append(nn.Conv2d(ndf * nf_prev, 1, kw, stride=1, padding=padw))
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)


def norm_conv(conv: nn.Module, norm: str = "weight") -> nn.Module:
    """``conv`` with weight norm, JAX's spectral norm or none (``NormConv``)."""
    if norm == "weight":
        return weight_norm(conv)
    if norm == "spectral":
        return spectral_norm(conv)
    if norm != "none":
        raise ValueError(f"unknown norm {norm!r}; expected weight, spectral or none")
    return conv


class _Multi(nn.Module):
    """A list of discriminators run on real and generated signals."""

    def single(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], List[List[torch.Tensor]]]:
        """(scores, feature maps) of every discriminator on one signal."""
        scores, fmaps = [], []
        for d, h in zip(self.discriminators, self.inputs(x)):
            s, f = d(h)
            scores.append(s)
            fmaps.append(f)
        return scores, fmaps

    def inputs(self, x: torch.Tensor):
        return [x] * len(self.discriminators)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        y_d_rs, fmap_rs = self.single(y)
        y_d_gs, fmap_gs = self.single(y_hat)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class DiscriminatorP(nn.Module):
    """Period discriminator (``hifigan.py:198-240``): the waveform folded into
    ``[T/p, p]`` and 2-D convs along time. Returns (score ``[B, N]``, maps)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 use_spectral_norm: bool = False):
        super().__init__()
        self.period = period
        norm = "spectral" if use_spectral_norm else "weight"
        chans = [1, 32, 128, 512, 1024]
        pad = (get_padding(5, 1), 0)
        self.convs = nn.ModuleList(
            [norm_conv(nn.Conv2d(cin, cout, (kernel_size, 1), (stride, 1), padding=pad), norm)
             for cin, cout in zip(chans[:-1], chans[1:])]
            + [norm_conv(nn.Conv2d(1024, 1024, (kernel_size, 1), 1, padding=(2, 0)), norm)])
        self.conv_post = norm_conv(nn.Conv2d(1024, 1, (3, 1), 1, padding=(1, 0)), norm)

    def forward(self, x: torch.Tensor):
        B, C, T = x.shape
        p = self.period
        if T % p:  # reflect padding excludes the edge sample (hifigan.py:228)
            x = reflect_pad(x, 0, p - T % p)
            T = x.shape[-1]
        h = x.view(B, C, T // p, p)
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return torch.flatten(h, 1), fmap


class MultiPeriodDiscriminator(_Multi):
    """Periods (2, 3, 5, 7, 11) (``hifigan.py:243-268``)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorP(p) for p in periods])


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped long-kernel 1-D convs (``hifigan.py:271-304``)."""

    SPEC = [(128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
            (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
            (1024, 5, 1, 1, 2)]  # (out, kernel, stride, groups, padding)

    def __init__(self, use_spectral_norm: bool = False):
        super().__init__()
        norm = "spectral" if use_spectral_norm else "weight"
        convs, cin = [], 1
        for ch, k, s, g, pad in self.SPEC:
            convs.append(norm_conv(nn.Conv1d(cin, ch, k, s, groups=g, padding=pad), norm))
            cin = ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = norm_conv(nn.Conv1d(1024, 1, 3, 1, padding=1), norm)

    def forward(self, x: torch.Tensor):
        fmap = []
        h = x
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return torch.flatten(h, 1), fmap


class MultiScaleDiscriminator(_Multi):
    """3 scales, the first spectral-normed, average pools of 4 / 2 between
    them (``hifigan.py:307-341``), padded by 1 as the JAX package pads."""

    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorS(use_spectral_norm=True),
                                             DiscriminatorS(), DiscriminatorS()])
        self.meanpools = nn.ModuleList([nn.AvgPool1d(4, 2, padding=1) for _ in range(2)])

    def inputs(self, x: torch.Tensor):
        xs = [x]
        for pool in self.meanpools:
            xs.append(pool(xs[-1]))
        return xs


def _stft_mag(x: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """|STFT| of ``[B, T]`` after a reflect pad of ``(n_fft - hop) // 2``
    (``center=False``, periodic Hann) -> ``[B, n_fft // 2 + 1, frames]``."""
    pad = (n_fft - hop) // 2
    x = reflect_pad(x, pad, pad)
    frames = x.unfold(-1, n_fft, hop)
    spec = torch.fft.rfft(frames * padded_hann(win, n_fft, x.device), n=n_fft, dim=-1)
    return torch.abs(spec).transpose(1, 2)


class DiscriminatorR(nn.Module):
    """One STFT-resolution discriminator (``bigvgan/models.py:277-331``)."""

    def __init__(self, resolution: Sequence[int], channel_mult: float = 1.0,
                 use_spectral_norm: bool = False):
        super().__init__()
        self.resolution = tuple(resolution)  # (n_fft, hop, win)
        norm = "spectral" if use_spectral_norm else "weight"
        ch = int(32 * channel_mult)
        specs = [((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)), ((3, 9), (1, 2)),
                 ((3, 3), (1, 1))]
        self.convs = nn.ModuleList([
            norm_conv(nn.Conv2d(1 if i == 0 else ch, ch, k, s, padding=(k[0] // 2, k[1] // 2)),
                      norm) for i, (k, s) in enumerate(specs)])
        self.conv_post = norm_conv(nn.Conv2d(ch, 1, (3, 3), 1, padding=(1, 1)), norm)

    def forward(self, x: torch.Tensor):
        h = _stft_mag(x[:, 0], *self.resolution)[:, None]  # [B, 1, F, frames]
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return torch.flatten(h, 1), fmap


class MultiResolutionDiscriminator(_Multi):
    """3 STFT resolutions (``bigvgan/models.py:332-355``)."""

    def __init__(self, resolutions: Sequence[Sequence[int]] = (
            (1024, 120, 600), (2048, 240, 1200), (512, 50, 240)), channel_mult: float = 1.0):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorR(r, channel_mult)
                                             for r in resolutions])


def _same_pads(n: int, k: int = 3, s: int = 2) -> Tuple[int, int]:
    """flax's ``padding="SAME"`` along an axis of n: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class _Tower(nn.Module):
    def __init__(self, win: int, freq: int, hidden: int):
        super().__init__()
        chans = [1, hidden // 4, hidden // 2, hidden]
        self.convs = nn.ModuleList([nn.Conv2d(a, b, 3, 2) for a, b in zip(chans[:-1], chans[1:])])
        for _ in range(3):
            win, freq = -(-win // 2), -(-freq // 2)
        self.out = nn.Linear(hidden * win * freq, 1)

    def forward(self, clip: torch.Tensor):
        h = clip[:, None]  # [B, 1, win, C]
        for conv in self.convs:
            (t0, t1), (f0, f1) = _same_pads(h.shape[2]), _same_pads(h.shape[3])
            h = F.leaky_relu(conv(F.pad(h, (f0, f1, t0, t1))), 0.2)
        # flattened in the JAX order (time, freq, channel)
        return self.out(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)), h


class MultiWindowDiscriminator(nn.Module):
    """Fixed-length mel clips through 2-D conv towers (3x3, stride 2, SAME,
    LeakyReLU 0.2), each flattened to one logit, summed
    (``multi_window_disc.py:66-148``; the JAX package's design). The clip
    starts are passed in; a start past ``T - win`` is clamped there, as
    ``lax.dynamic_slice`` clamps it. Names follow the JAX module
    (``towers.{i}.convs.{j}``, ``towers.{i}.out``)."""

    def __init__(self, time_lengths: Sequence[int] = (32, 64, 128), freq_length: int = 80,
                 hidden_size: int = 128):
        super().__init__()
        self.time_lengths = tuple(time_lengths)
        self.towers = nn.ModuleList([_Tower(w, freq_length, hidden_size)
                                     for w in time_lengths])

    def forward(self, x: torch.Tensor, start_frames: Sequence[int]):
        """``x``: mel ``[B, T, C]`` -> (validity ``[B, 1]``, tower maps)."""
        validity, feats = 0.0, []
        for tower, win, s in zip(self.towers, self.time_lengths, start_frames):
            s = min(max(int(s), 0), x.shape[1] - win)
            v, h = tower(x[:, s: s + win])
            validity = validity + v
            feats.append(h)
        return validity, feats


# --- loss helpers (``hifigan.py:344-382``, LSGAN form) ---------------------

def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2.0


def discriminator_loss(real_outs, gen_outs) -> Tuple[torch.Tensor, torch.Tensor]:
    r_losses, g_losses = 0.0, 0.0
    for dr, dg in zip(real_outs, gen_outs):
        r_losses = r_losses + torch.mean((1.0 - dr) ** 2)
        g_losses = g_losses + torch.mean(dg ** 2)
    n = len(real_outs)
    return r_losses / n, g_losses / n


def generator_loss(disc_outputs) -> torch.Tensor:
    loss = 0.0
    for dg in disc_outputs:
        loss = loss + torch.mean((1.0 - dg) ** 2)
    return loss / len(disc_outputs)


def cond_discriminator_loss(outputs) -> torch.Tensor:
    loss = 0.0
    for dg in outputs:
        loss = loss + torch.mean(dg ** 2)
    return loss / len(outputs)
