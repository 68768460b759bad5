"""The VAE-GAN loss of stage 1 (port of ``versband_tpu/train/gan_losses.py``;
reference ``LPAPSWithDiscriminator``, ``configs/ae_accomp.yaml``: disc_start
80001, kl 1e-6, disc_weight 0.5, disc_factor 2, mse disc loss, r1 weight 3).

``VAEGANLoss`` holds the scalar ``logvar`` (trained by no optimizer: its
gradient in the discriminator's loss is exactly 0) and the PatchGAN
discriminator, and computes the loss terms the train step
(:mod:`versband_tpu_torch.train.vae_step`) composes:

* ``nll_kl``: L1 reconstruction over ``exp(logvar)`` plus ``logvar``, summed
  per batch item, and the posterior's KL;
* ``g_loss``: ``-mean(D(recon))``;
* ``d_loss``: the MSE (LSGAN), hinge or vanilla discriminator loss.

``adaptive_d_weight`` turns the two gradient norms at the decoder's last
layer into ``clamp(|grad nll| / (|grad g| + 1e-4), 0, 1e4) * disc_weight``,
detached.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from versband_tpu_torch.vocoder.discriminators import NLayerDiscriminator


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """``weight`` from step ``threshold`` on, ``value`` before it."""
    return value if global_step < threshold else weight


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def mse_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    """``0.5 * (mean((1 - real)^2) + mean(fake^2))``."""
    return 0.5 * (((1.0 - logits_real) ** 2).mean() + (logits_fake ** 2).mean())


D_LOSSES = {"hinge": hinge_d_loss, "vanilla": vanilla_d_loss, "mse": mse_d_loss}


class VAEGANLoss(nn.Module):
    """``logvar`` and the discriminator, with the loss arithmetic; the
    parameter names are the reference's (``logvar``, ``discriminator.main.*``).
    ``pixelloss_weight`` is taken and unused, as in the reference and JAX."""

    def __init__(self, disc_start: int = 80001, logvar_init: float = 0.0,
                 kl_weight: float = 1e-6, pixelloss_weight: float = 1.0,
                 disc_num_layers: int = 3, disc_in_channels: int = 1,
                 disc_hidden_size: int = 64, disc_factor: float = 2.0,
                 disc_weight: float = 0.5, perceptual_weight: float = 0.0,
                 use_actnorm: bool = False, disc_conditional: bool = False,
                 disc_loss: str = "mse", r1_reg_weight: float = 3.0):
        super().__init__()
        if perceptual_weight != 0.0:
            raise ValueError("the perceptual (LPIPS) loss is not used: perceptual_weight must be 0")
        if disc_loss not in D_LOSSES:
            raise ValueError(f"disc_loss {disc_loss!r} is not one of {sorted(D_LOSSES)}")
        self.disc_start = disc_start
        self.kl_weight = kl_weight
        self.disc_factor = float(disc_factor)
        self.disc_weight = float(disc_weight)
        self.disc_conditional = disc_conditional
        self.disc_loss = disc_loss
        self.r1_reg_weight = r1_reg_weight
        self.logvar = nn.Parameter(torch.tensor(float(logvar_init)))
        self.discriminator = NLayerDiscriminator(disc_in_channels, disc_hidden_size,
                                                 disc_num_layers, use_actnorm)

    @staticmethod
    def _as_image(x: torch.Tensor) -> torch.Tensor:
        """Mels ``[B, 80, T]`` as 1-channel images ``[B, 1, 80, T]``."""
        return x[:, None] if x.ndim == 3 else x

    def nll_kl(self, inputs: torch.Tensor, reconstructions: torch.Tensor, posterior,
               weights: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        rec_loss = (self._as_image(inputs) - self._as_image(reconstructions)).abs()
        nll = rec_loss / torch.exp(self.logvar) + self.logvar
        weighted = nll if weights is None else weights * nll
        B = inputs.shape[0]
        return {"rec_loss": rec_loss.mean(), "nll_loss": nll.sum() / B,
                "weighted_nll_loss": weighted.sum() / B,
                "kl_loss": posterior.kl().sum() / B, "logvar": self.logvar}

    def disc_forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self._as_image(x)
        if cond is not None:
            if not self.disc_conditional:
                raise ValueError("a condition was given to an unconditional discriminator")
            h = torch.cat([h, self._as_image(cond)], dim=1)
        elif self.disc_conditional:
            raise ValueError("the conditional discriminator needs its condition")
        return self.discriminator(h)

    def g_loss(self, reconstructions: torch.Tensor,
               cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The generator's adversarial term, ``-mean(D(recon))``."""
        return -self.disc_forward(reconstructions, cond).mean()

    def d_loss(self, logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
        return D_LOSSES[self.disc_loss](logits_real, logits_fake)


def adaptive_d_weight(nll_grad_norm: torch.Tensor, g_grad_norm: torch.Tensor,
                      disc_weight: float) -> torch.Tensor:
    d_weight = nll_grad_norm / (g_grad_norm + 1e-4)
    return torch.clamp(d_weight, 0.0, 1e4).detach() * disc_weight
