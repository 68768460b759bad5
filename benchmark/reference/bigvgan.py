"""The plain reference of BigVGAN's generator (Lee, Ping, Ginsburg, Catanzaro
and Yoon, ICLR 2023, arXiv:2206.04658), in float32 with TF32 off.

A function of a weight dict in the published implementation's state-dict
names (``conv_pre``, ``ups.{i}.0``, ``resblocks.{i*K+j}.convs1.{n}`` /
``convs2.{n}``, ``resblocks.{...}.activations.{m}.act.{alpha,beta}``,
``activation_post.act.*``, ``conv_post``) and plain ``torch`` operations, as
the paper and its code (``models.py``, ``activations.py``,
``alias_free_torch/``) describe the generator:

* ``conv_pre`` (kernel 7), then per stage a transposed convolution (rate u,
  kernel k, padding (k - u) // 2) and the mean of ``len(resblock_kernel_sizes)``
  AMP blocks on its output;
* an AMP block (``resblock "1"``) is, per dilation d, x + conv2(act(conv1_d(act(x))))
  with "same" padding;
* every activation is alias-free: a 2x upsample (replicate padding, a
  12-tap kaiser-sinc transposed depthwise convolution times 2, cropped),
  Snake or SnakeBeta ``y + sin^2(alpha y) / (beta + 1e-9)`` (``alpha``,
  ``beta`` exponentiated with ``snake_logscale``; Snake takes beta = alpha),
  then a 2x low-pass and decimate (replicate padding, the same taps,
  stride 2);
* after the last stage: an activation, ``conv_post`` (kernel 7) and tanh.

Where this departs from the published code, and where the port's wrapper
(``versband_tpu_torch/vocoder/bigvgan.py``, ``VocoderBigVGAN``) differs:

* the weights are in serving form, weight norm folded, as a loaded
  checkpoint serves; the resamplers' taps are computed here, not buffers;
* only ``resblock "1"`` (AMPBlock1) is written: the published 112M
  generator uses it;
* the configuration runs at a hop of 320 with rates [5, 4, 2, 2, 2, 2] and
  kernels [9, 8, 4, 4, 4, 4] where the published 24 kHz model has a hop of
  256; the 5x stage takes kernel 9, so that (k - u) // 2 padding keeps the
  length exact, and 80 mel bands where it has 100 (nothing here depends on
  either: they are the configuration's numbers);
* the port runs each activation as one call of K4 on the card (its FIRs
  summed in another order, sin^2 by a reduced polynomial), where this runs
  the three steps unfused.

Nothing here imports the program or JAX, and no kernel is used.
``Precision`` (``benchmark/reference/pwg.py``) says how every convolution
of the model is computed: ``fp32`` (the reference), ``tf32`` (operands
rounded to TF32, one pass, the control of the float32 vocoder) or ``bf16``;
the resamplers' taps and Snake stay float32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.pwg import Precision, no_tf32

Weights = Dict[str, torch.Tensor]
TAPS = 12  # the published Activation1d's up and down kernel size at ratio 2

__all__ = ["Precision", "kaiser_sinc_taps", "activation", "generator", "vocode"]


def kaiser_sinc_taps(cutoff: float, half_width: float, kernel_size: int) -> torch.Tensor:
    """The published ``kaiser_sinc_filter1d``: a kaiser-windowed sinc
    low-pass, sum-normalised, ``[kernel_size]`` in float32."""
    even = kernel_size % 2 == 0
    half = kernel_size // 2
    A = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(kernel_size, periodic=False, beta=beta, dtype=torch.float64)
    t = torch.arange(-half, half, dtype=torch.float64) + 0.5 if even else \
        torch.arange(kernel_size, dtype=torch.float64) - half
    f = 2 * cutoff * window * torch.sinc(2 * cutoff * t)
    return (f / f.sum()).float()


def _upsample2(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    k, C = taps.numel(), x.shape[1]
    pad = k // 2 - 1
    left, right = pad * 2 + (k - 2) // 2, pad * 2 + (k - 1) // 2
    y = 2 * F.conv_transpose1d(F.pad(x, (pad, pad), mode="replicate"),
                               taps.view(1, 1, k).expand(C, -1, -1), stride=2, groups=C)
    return y[..., left:y.shape[-1] - right]


def _downsample2(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    k, C = taps.numel(), x.shape[1]
    y = F.pad(x, (k // 2 - int(k % 2 == 0), k // 2), mode="replicate")
    return F.conv1d(y, taps.view(1, 1, k).expand(C, -1, -1), stride=2, groups=C)


def activation(x: torch.Tensor, alpha: torch.Tensor, beta, logscale: bool) -> torch.Tensor:
    """The alias-free Snake(Beta) over ``[B, C, T]`` in float32; ``beta``
    None is Snake."""
    taps = kaiser_sinc_taps(0.25, 0.3, TAPS).to(x.device)
    a = alpha.float()
    b = a if beta is None else beta.float()
    if logscale:
        a, b = a.exp(), b.exp()
    y = _upsample2(x.float(), taps)
    y = y + (1.0 / (b[None, :, None] + 1e-9)) * torch.sin(y * a[None, :, None]) ** 2
    return _downsample2(y, taps)


def _act(W: Weights, prefix: str, x: torch.Tensor, logscale: bool) -> torch.Tensor:
    return activation(x, W[prefix + "act.alpha"], W.get(prefix + "act.beta"), logscale)


def _amp_block(W: Weights, p: str, x: torch.Tensor, k: int, dilations, logscale: bool,
               P: Precision) -> torch.Tensor:
    for n, d in enumerate(dilations):
        c1, c2 = f"{p}convs1.{n}.", f"{p}convs2.{n}."
        h = _act(W, f"{p}activations.{2 * n}.", x, logscale)
        h = P.conv(h, W[c1 + "weight"], W[c1 + "bias"], dilation=d, padding=(k * d - d) // 2)
        h = _act(W, f"{p}activations.{2 * n + 1}.", h, logscale)
        x = x + P.conv(h, W[c2 + "weight"], W[c2 + "bias"], padding=(k - 1) // 2)
    return x


@torch.no_grad()
def generator(W: Weights, cfg: dict, mel: torch.Tensor, P: Precision) -> torch.Tensor:
    """mel ``[B, num_mels, T]`` -> waveform ``[B, T x prod(upsample_rates)]``."""
    if str(cfg.get("resblock", "1")) != "1":
        raise ValueError("the reference has AMPBlock1 (resblock '1') only")
    logscale = cfg.get("snake_logscale", True)
    kernels = cfg["resblock_kernel_sizes"]
    with no_tf32():
        x = P.conv(mel.float(), W["conv_pre.weight"], W["conv_pre.bias"], padding=3)
        for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
            x = P.conv_t(x, W[f"ups.{i}.0.weight"], W[f"ups.{i}.0.bias"], stride=u,
                         padding=(k - u) // 2)
            acc = None
            for j, (rk, rd) in enumerate(zip(kernels, cfg["resblock_dilation_sizes"])):
                y = _amp_block(W, f"resblocks.{i * len(kernels) + j}.", x, rk, rd, logscale, P)
                acc = y if acc is None else acc + y
            x = acc / len(kernels)
        x = _act(W, "activation_post.", x, logscale)
        x = P.conv(x, W["conv_post.weight"], W["conv_post.bias"], padding=3)
        return torch.tanh(x)[:, 0]


def vocode(W: Weights, cfg: dict, mel: torch.Tensor, P: Precision) -> torch.Tensor:
    """mel ``[B, num_mels, T]`` -> waveform, one take at a time, as the
    serving path vocodes."""
    return torch.cat([generator(W, cfg, mel[i:i + 1], P) for i in range(len(mel))])
