"""Diagonal Gaussian posterior of the KL-VAE (port of ``versband_tpu/models/distributions.py``).

Moments are ``[mean, logvar]`` concatenated on the channel axis; logvar is
clamped to [-30, 20]. Sampling takes a ``torch.Generator`` or the
noise itself.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


class DiagonalGaussian:
    def __init__(self, moments: torch.Tensor, deterministic: bool = False,
                 channel_axis: int = 1):
        self.mean, logvar = moments.chunk(2, dim=channel_axis)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.deterministic = deterministic
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * eps, eps from ``generator`` unless ``noise`` is given."""
        if self.deterministic:
            return self.mean
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + self.std * noise.to(self.mean)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussian"] = None) -> torch.Tensor:
        dims = tuple(range(1, self.mean.ndim))
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], dtype=self.mean.dtype,
                               device=self.mean.device)
        if other is None:
            return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum((self.mean - other.mean) ** 2 / other.var
                               + self.var / other.var - 1.0 - self.logvar + other.logvar,
                               dim=dims)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros(sample.shape[0], dtype=sample.dtype, device=sample.device)
        dims = tuple(range(1, sample.ndim))
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + self.logvar
                               + (sample - self.mean) ** 2 / self.var, dim=dims)


def normal_kl(mean1: torch.Tensor, logvar1: torch.Tensor, mean2: torch.Tensor,
              logvar2: torch.Tensor) -> torch.Tensor:
    """KL(N(mean1, e^logvar1) || N(mean2, e^logvar2)) per element, broadcasting."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))
