"""The VAE-GAN train and eval steps of stage 1 (port of
``versband_tpu/train/vae_step.py``).

One train step on one batch, as the JAX step computes it:

1. the generator: one VAE forward with a posterior sample, the L1/KL terms
   and the adversarial term ``g``; the adaptive weight from the gradients
   of ``nll`` and of ``g`` at the decoder's last conv (two
   ``torch.autograd.grad`` calls on the same graph, which JAX gets from two
   more forwards with the same draw); the backward of
   ``weighted_nll + kl_weight * kl + d_weight * disc_factor * g`` into the
   VAE's parameters only, and Adam;
2. the discriminator, on the detached reconstruction: ``disc_factor`` times
   the GAN loss plus ``r1_reg_weight`` times the R1 penalty
   ``mean((d sum D(mel) / d mel)^2)`` over every element (a
   ``create_graph`` gradient, so the discriminator's backward goes through
   it), and Adam over the loss module's parameters, the BatchNorm
   statistics among them; ``logvar`` gets no gradient and stays where it is.

``disc_factor`` is ``adopt_weight(disc_factor, step, disc_start)`` at the
generator's step before its update; before ``disc_start`` the discriminator
still steps, on the R1 term alone.

The posterior's standard-normal draw comes from a ``torch.Generator``, or is
handed in as ``given["posterior"]`` (how the tests feed the JAX step's draw).

Under a process group the two gradients at the last conv are averaged over
the ranks before their norms, so ``d_weight`` is the global batch's, and each
backward's gradients are averaged before Adam; the metrics are averaged too. Every other term is a mean of
per-item terms (the PatchGAN normalises by its trained running statistics,
not by the batch's), so the averaged gradient is the global batch's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from versband_tpu_torch.models.autoencoder import AutoencoderKL
from versband_tpu_torch.parallel import average_, mean_metrics
from versband_tpu_torch.train.gan_losses import VAEGANLoss, adaptive_d_weight, adopt_weight
from versband_tpu_torch.train.state import TrainState
from versband_tpu_torch.utils.profiling import annotate, tag


def vae_forward(vae: AutoencoderKL, mel: torch.Tensor, generator: Optional[torch.Generator],
                noise: Optional[torch.Tensor] = None):
    """(reconstruction, posterior) of ``mel`` through a posterior sample."""
    posterior = vae.encode(mel)
    if noise is None:
        noise = torch.randn(posterior.mean.shape, generator=generator,
                            device=posterior.mean.device, dtype=posterior.mean.dtype)
    return vae.decode(posterior.sample(noise=noise)), posterior


def make_vae_train_step(vae: AutoencoderKL, loss: VAEGANLoss) -> Callable[..., Dict[str, Any]]:
    """Build ``step(gen_state, disc_state, batch, generator=None, given=None)
    -> metrics``; ``gen_state`` wraps ``vae``, ``disc_state`` wraps ``loss``.
    Metrics stay on the device, but for ``disc_factor`` (a host float). Its
    spans: ``train.vae_step`` (tagged with ``gen_state.step``) around
    ``train.vae_step.generator`` and ``train.vae_step.discriminator``."""
    last = vae.decoder.conv_out.weight

    def step(gen_state: TrainState, disc_state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             given: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
        with tag(gen_state.step), annotate("train.vae_step"):
            given = given or {}
            mel = batch["image"]
            disc_factor = adopt_weight(loss.disc_factor, gen_state.step, loss.disc_start)

            # generator update
            with annotate("train.vae_step.generator"):
                recon, posterior = vae_forward(vae, mel, generator, given.get("posterior"))
                stats = loss.nll_kl(mel, recon, posterior)
                g = loss.g_loss(recon)
                nll_grad, = torch.autograd.grad(stats["nll_loss"], last, retain_graph=True)
                g_grad, = torch.autograd.grad(g, last, retain_graph=True)
                average_([nll_grad, g_grad])
                d_weight = adaptive_d_weight(torch.linalg.vector_norm(nll_grad),
                                             torch.linalg.vector_norm(g_grad), loss.disc_weight)
                aeloss = (stats["weighted_nll_loss"] + loss.kl_weight * stats["kl_loss"]
                          + d_weight * disc_factor * g)
                aeloss.backward(inputs=gen_state.params)  # no gradient reaches the discriminator
                gen_state.reduce_gradients()
                gen_state.apply_gradients()

            # discriminator update, on the detached reconstruction
            with annotate("train.vae_step.discriminator"):
                real = mel.detach().requires_grad_(True)
                logits_fake = loss.disc_forward(recon.detach())
                logits_real = loss.disc_forward(real)
                r1_grad, = torch.autograd.grad(logits_real.sum(), real, create_graph=True)
                r1 = r1_grad.square().mean()
                discloss = (disc_factor * loss.d_loss(logits_real, logits_fake)
                            + loss.r1_reg_weight * r1)
                discloss.backward(inputs=disc_state.params)
                disc_state.reduce_gradients()
                disc_state.apply_gradients()

            metrics = {"aeloss": aeloss.detach(), "discloss": discloss.detach(),
                       "rec_loss": stats["rec_loss"].detach(),
                       "nll_loss": stats["nll_loss"].detach(),
                       "kl_loss": stats["kl_loss"].detach(), "g_loss": g.detach(),
                       "d_weight": d_weight, "disc_factor": disc_factor,
                       "disc_loss": discloss.detach(), "r1_penalty": r1.detach(),
                       "logits_real": logits_real.detach().mean(),
                       "logits_fake": logits_fake.detach().mean()}
            means = mean_metrics({k: v for k, v in metrics.items() if torch.is_tensor(v)})
            return {k: means.get(k, v) for k, v in metrics.items()}

    return step


def make_vae_eval_step(vae: AutoencoderKL, loss: VAEGANLoss) -> Callable[..., Dict[str, Any]]:
    """Build ``step(batch, generator=None, given=None) -> {val/rec_loss,
    val/kl_loss, val/mse}`` (no updates; the posterior sampled as in
    training)."""

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
             given: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        mel = batch["image"]
        recon, posterior = vae_forward(vae, mel, generator, (given or {}).get("posterior"))
        stats = loss.nll_kl(mel, recon, posterior)
        return {"val/rec_loss": stats["rec_loss"], "val/kl_loss": stats["kl_loss"],
                "val/mse": ((recon - mel) ** 2).mean()}

    return step
