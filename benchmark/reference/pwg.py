"""The plain reference of Parallel WaveGAN's generator (Yamamoto, Song and
Kim, ICASSP 2020, arXiv:1910.11480), in float32 with TF32 off.

A function of a weight dict in the reference implementation's state-dict
names (``upsample_net.conv_in``, ``upsample_net.upsample.up_layers.{2j+1}``,
``first_conv``, ``conv_layers.{i}.{conv,conv1x1_aux,conv1x1_skip,conv1x1_out}``,
``last_conv_layers.{1,3}``) and plain ``torch`` operations, as the paper
describes the generator:

* the auxiliary mel, edge-padded by ``aux_context_window`` frames a side,
  goes through the context conv (kernel 2w + 1, no padding, no bias), then
  per upsampling scale s a nearest stretch by s and a ``(1, 2s + 1)``
  smoothing conv over time;
* the noise goes through ``first_conv`` (1x1), then ``layers`` gated
  residual layers in ``stacks`` dilation cycles (1, 2, ..., 2^(L/stacks - 1)):
  a dilated kernel-3 conv to 2G channels, the aux 1x1 added to it,
  ``tanh(a) * sigmoid(b)`` of its halves, a skip 1x1 summed over the layers
  in float32 and an out 1x1 added to the residual, scaled by sqrt(0.5);
* the skip sum times sqrt(1 / layers), then ReLU, 1x1, ReLU, 1x1.

Where the port's wrapper (``versband_tpu_torch/vocoder/pwg.py``,
``ParallelWaveGAN``) differs from this description:

* it draws the noise itself, from a ``torch.Generator`` of its own that
  moves on from call to call; here the noise is an argument;
* its residual layers run fused (K5 on the card): each layer's products as
  three TF32 passes on the tensor cores, the gate and z never stored, the
  skip sum threaded through the layers as an fp32 accumulator;
* its weights are in serving form, with weight norm folded;
* it casts the mel to its own type before the padding, and in bfloat16
  every product and activation would be bfloat16 (the skip sum stays
  float32);
* it can concatenate a pitch embedding to the mel (``use_pitch_embed``,
  off in serving), which the paper does not have.

Nothing here imports the program or JAX, and no kernel is used.
``Precision`` says how every product is computed: ``fp32`` (the reference),
``tf32`` (operands rounded to TF32, one pass, the control of the float32
vocoder), ``bf16`` (operands rounded to bfloat16) or ``fp8``
(``benchmark/reference/models.py``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator

import torch
import torch.nn.functional as F

from benchmark.reference import models

Weights = Dict[str, torch.Tensor]


class Precision(models.Precision):
    """``models.Precision`` with a ``bf16`` mode: both operands rounded to
    bfloat16 (to nearest even), the products summed in float32."""

    def __init__(self, mode: str = "fp32"):
        if mode == "bf16":
            self.mode = mode
        else:
            super().__init__(mode)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "bf16":
            return x.to(torch.bfloat16).float()
        return super().q(x)

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.q(x), self.q(w), b, **kw)


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """float32 products in float32: TF32 off for the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def dilations(cfg: dict) -> list:
    per_stack = cfg["layers"] // cfg["stacks"]
    return [2 ** (i % per_stack) for i in range(cfg["layers"])]


def pad_mel(mel: torch.Tensor, cfg: dict) -> torch.Tensor:
    """mel ``[B, A, T']`` edge-padded by ``aux_context_window`` frames a side."""
    w = cfg["aux_context_window"]
    return F.pad(mel.float(), (w, w), mode="replicate")


@torch.no_grad()
def generator(W: Weights, cfg: dict, noise: torch.Tensor, c: torch.Tensor,
              P: Precision) -> torch.Tensor:
    """(noise ``[B, 1, T]``, padded mel ``[B, A, T' + 2w]``) -> waveform
    ``[B, T]``, T = T' x prod(upsample_scales)."""
    with no_tf32():
        noise, c = noise.float(), c.float()
        c = P.conv(c, W["upsample_net.conv_in.weight"])
        for j, s in enumerate(cfg["upsample_scales"]):
            c = torch.repeat_interleave(c, s, dim=-1)
            w = W[f"upsample_net.upsample.up_layers.{2 * j + 1}.weight"]
            c = P.conv2d(c[:, None], w, padding=(0, s))[:, 0]
        if c.shape[-1] != noise.shape[-1]:
            raise ValueError(f"aux length {c.shape[-1]} != noise length {noise.shape[-1]}")
        h = P.conv(noise, W["first_conv.weight"], W["first_conv.bias"])
        skips = torch.zeros(h.shape[0], W["last_conv_layers.1.weight"].shape[0], h.shape[-1],
                            device=h.device)
        for i, d in enumerate(dilations(cfg)):
            p = f"conv_layers.{i}."
            k = cfg["kernel_size"]
            a = P.conv(h, W[p + "conv.weight"], W[p + "conv.bias"], dilation=d,
                       padding=(k - 1) // 2 * d)
            a = a + P.conv(c, W[p + "conv1x1_aux.weight"])
            xa, xb = a.chunk(2, dim=1)
            z = torch.tanh(xa) * torch.sigmoid(xb)
            skips = skips + P.conv(z, W[p + "conv1x1_skip.weight"], W[p + "conv1x1_skip.bias"])
            h = (P.conv(z, W[p + "conv1x1_out.weight"], W[p + "conv1x1_out.bias"]) + h) \
                * math.sqrt(0.5)
        z = F.relu(skips * math.sqrt(1.0 / cfg["layers"]))
        z = F.relu(P.conv(z, W["last_conv_layers.1.weight"], W["last_conv_layers.1.bias"]))
        return P.conv(z, W["last_conv_layers.3.weight"], W["last_conv_layers.3.bias"])[:, 0]


def vocode(W: Weights, cfg: dict, mel: torch.Tensor, noise: torch.Tensor,
           P: Precision) -> torch.Tensor:
    """mel ``[B, A, T']`` and noise ``[B, 1, T]`` -> waveform ``[B, T]``: the
    mel edge-padded as the wrapper pads it, then ``generator``."""
    return generator(W, cfg, noise, pad_mel(mel, cfg), P)
