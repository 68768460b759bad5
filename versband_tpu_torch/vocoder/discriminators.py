"""The PatchGAN discriminator of stage 1's VAE-GAN (port of
``versband_tpu/vocoder/discriminators.py``: ``ActNorm`` and
``NLayerDiscriminator``; reference ``ldm/modules/discriminator/model.py``).

Mels are seen as 1-channel images ``[B, 1, 80, T]``; the output is a map of
patch logits ``[B, 1, H', W']``. Key names are the reference's ``nn.Sequential``
``main``: ``main.0`` the first conv, then per layer n = 1..``n_layers`` the conv
``main.{3n-1}`` and its norm ``main.{3n}``, and the last conv
``main.{3 n_layers + 2}``, so a reference Lightning checkpoint's
``loss.discriminator.main.*`` loads as it is.

Two behaviours follow the JAX package, not the reference (ROADMAP Queue 3):

* the norm is ``RunningStatsBatchNorm2d``: it normalises by ``running_mean``
  and ``running_var``, which are parameters that the discriminator's
  optimizer trains, never batch statistics. The JAX trainer runs BatchNorm
  with ``use_running_average`` and differentiates its whole variable tree,
  ``batch_stats`` included; the reference runs BatchNorm in training mode;
* ``ActNorm`` starts at loc 0, scale 1 and has no data-dependent init.
"""

from __future__ import annotations

import torch
import torch.nn as nn


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
