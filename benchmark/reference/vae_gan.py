"""The plain reference of AccompBand's stage-1 training step (the VAE-GAN of
``configs/ae_accomp.yaml``), in float32.

Per step, from the batch the trainer fed and the trainer's seed: the 1-D
KL-VAE forward through a posterior sample (the one draw of a step); the L1
reconstruction over ``exp(logvar)`` plus ``logvar`` and the KL, summed per
item; the generator's adversarial term ``-mean(D(recon))`` of the PatchGAN;
the adaptive weight from the two gradients at the decoder's last conv; the
VAE's Adam(0.5, 0.9) step; then the discriminator's, on the detached
reconstruction: the LSGAN loss and the R1 penalty (the squared gradient of
``sum D(mel)`` with respect to the mel, by a double backward), and its own
Adam step over the PatchGAN and ``logvar``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import models as ref
from benchmark.reference.train import posterior_sample, tf32, vae_moments


def patchgan(W: Dict[str, torch.Tensor], x: torch.Tensor, n_layers: int = 3) -> torch.Tensor:
    """``NLayerDiscriminator`` on ``[B, 1, H, W]``: 4x4 convs, LeakyReLU 0.2,
    a norm by trained running statistics after each inner conv."""
    h = F.leaky_relu(F.conv2d(x, W["main.0.weight"], W["main.0.bias"], stride=2, padding=1), 0.2)
    i = 2
    for n in range(1, n_layers + 1):
        h = F.conv2d(h, W[f"main.{i}.weight"], None, stride=2 if n < n_layers else 1, padding=1)
        b = f"main.{i + 1}."
        mul = torch.rsqrt(W[b + "running_var"] + 1e-5) * W[b + "weight"]
        h = (h - W[b + "running_mean"].view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) \
            + W[b + "bias"].view(1, -1, 1, 1)
        h = F.leaky_relu(h, 0.2)
        i += 3
    return F.conv2d(h, W[f"main.{i}.weight"], W[f"main.{i}.bias"], stride=1, padding=1)


def _adam(params, grads, m, v, n, lr, betas, eps):
    for k, g in grads.items():
        m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
        v[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
        denom = (v[k] / (1 - betas[1] ** n)).sqrt() + eps
        params[k].sub_(lr * (m[k] / (1 - betas[0] ** n)) / denom)


def vaegan_steps(W: Dict[str, Dict[str, torch.Tensor]], model: dict,
                 batches: List[Dict[str, Any]], seed: int, lr: float, device,
                 use_tf32: bool = False, betas=(0.5, 0.9), eps: float = 1e-8) -> Dict[str, Any]:
    """``len(batches)`` steps from ``W`` (``vae``, ``gan``): each step's
    generator and discriminator loss, each leaf's norm of its first gradient
    and of its parameters' change over the steps (leaves ``vae.*``, ``gan.*``)."""
    dd = model["params"]["ddconfig"]
    lc = model["params"]["lossconfig"]["params"]
    g = torch.Generator(device=device).manual_seed(seed)
    P = {"vae": {k: v.clone().requires_grad_(True) for k, v in W["vae"].items()},
         "gan": {k: v.clone().requires_grad_(True) for k, v in W["gan"].items()}}
    start = {(m, k): v.detach().clone() for m in P for k, v in P[m].items()}
    mom = {m: {k: torch.zeros_like(v) for k, v in P[m].items()} for m in P}
    var = {m: {k: torch.zeros_like(v) for k, v in P[m].items()} for m in P}
    D = {k[len("discriminator."):]: v for k, v in P["gan"].items() if k.startswith("discriminator.")}
    logvar = P["gan"]["logvar"]
    last = P["vae"]["decoder.conv_out.weight"]
    losses, grad1 = [], {}
    with tf32(use_tf32):
        for step, batch in enumerate(batches):
            # the discriminator's weight is switched on at disc_start
            disc_factor = float(lc["disc_factor"]) if step >= int(lc["disc_start"]) else 0.0
            mel = torch.as_tensor(np.asarray(batch["image"]), device=device, dtype=torch.float32)
            B = mel.shape[0]
            moments = vae_moments(P["vae"], dd, mel)
            z = posterior_sample(moments, g)
            recon = ref.vae_decode(P["vae"], dd, z, ref.Precision())
            mean, logv = moments.chunk(2, dim=1)
            logv = torch.clamp(logv, -30.0, 20.0)
            rec = (mel[:, None] - recon[:, None]).abs()
            nll = (rec / torch.exp(logvar) + logvar).sum() / B
            kl = 0.5 * torch.sum(mean ** 2 + torch.exp(logv) - 1.0 - logv) / B
            gl = -patchgan(D, recon[:, None]).mean()
            nll_grad, = torch.autograd.grad(nll, last, retain_graph=True)
            g_grad, = torch.autograd.grad(gl, last, retain_graph=True)
            d_weight = torch.clamp(nll_grad.norm() / (g_grad.norm() + 1e-4), 0.0, 1e4).detach() \
                * float(lc["disc_weight"])
            aeloss = nll + float(lc["kl_weight"]) * kl + d_weight * disc_factor * gl
            names = list(P["vae"])
            grads = dict(zip(names, torch.autograd.grad(aeloss, [P["vae"][k] for k in names])))
            real = mel.detach().requires_grad_(True)
            logits_fake = patchgan(D, recon.detach()[:, None])
            logits_real = patchgan(D, real[:, None])
            r1_grad, = torch.autograd.grad(logits_real.sum(), real, create_graph=True)
            r1 = r1_grad.square().mean()
            d_loss = 0.5 * (((1.0 - logits_real) ** 2).mean() + (logits_fake ** 2).mean())
            discloss = disc_factor * d_loss + float(lc["r1_reg_weight"]) * r1
            gnames = list(P["gan"])
            dgrads = torch.autograd.grad(discloss, [P["gan"][k] for k in gnames],
                                         allow_unused=True)
            dgrads = {k: torch.zeros_like(P["gan"][k]) if gr is None else gr
                      for k, gr in zip(gnames, dgrads)}
            losses += [float(aeloss.detach()), float(discloss.detach())]
            with torch.no_grad():
                if step == 0:
                    grad1 = {**{f"vae.{k}": float(v.norm()) for k, v in grads.items()},
                             **{f"gan.{k}": float(v.norm()) for k, v in dgrads.items()}}
                _adam(P["vae"], grads, mom["vae"], var["vae"], step + 1, lr, betas, eps)
                _adam(P["gan"], dgrads, mom["gan"], var["gan"], step + 1, lr, betas, eps)
    delta = {f"{m}.{k}": float((v.detach() - start[(m, k)]).norm())
             for m in P for k, v in P[m].items()}
    return {"losses": losses, "grad1": grad1, "delta": delta}
