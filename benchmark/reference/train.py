"""The plain reference of AccompBand's stage-2 training step, in float32.

Given the weights, the batches the trainer fed and the seed of its draws, it
makes the same steps again: the frozen caption tower on each row's caption,
the frozen 1-D KL-VAE encoder and its posterior sample, the latent scale
(1 / std of the first batch's sample), t ~ randint(0, 1000), the OT-CFM
loss of the Band-MoE DiT in training routing (soft gates with Gumbel noise)
plus its load-balance loss, the gradient, its clip to global norm 1 and
AdamW's update. The draws come from one ``torch.Generator`` seeded as the
trainer seeds its own, in the trainer's order: the scale's posterior, then
per step the posterior, t, the noise and each block's three Gumbel draws.

``tf32`` computes the products in TF32 (the control the comparison has to
fail); otherwise TF32 is off, as float32 states.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import models as ref


def _gn(W, x, name):
    c = x.shape[1]
    return F.group_norm(x, 32 if c >= 32 else c, W[name + ".weight"], W[name + ".bias"], 1e-6)


def _conv(W, x, name, k, **kw):
    return F.conv1d(x, W[name + ".weight"], W[name + ".bias"], padding=k // 2, **kw)


def _resnet(W, x, name, k):
    h = _conv(W, F.silu(_gn(W, x, name + ".norm1")), name + ".conv1", k)
    h = _conv(W, F.silu(_gn(W, h, name + ".norm2")), name + ".conv2", k)
    if name + ".nin_shortcut.weight" in W:
        x = _conv(W, x, name + ".nin_shortcut", 1)
    return x + h


def vae_moments(W, dd: dict, mel: torch.Tensor) -> torch.Tensor:
    """``Encoder1D`` then the quant conv: ``[B, 80, T]`` -> ``[B, 2 * embed, T']``."""
    P = ref.Precision()
    k = dd.get("kernel_size", 3)
    h = _conv(W, mel, "encoder.conv_in", k)
    for i in range(len(dd["ch_mult"])):
        for j in range(dd["num_res_blocks"]):
            h = _resnet(W, h, f"encoder.down.{i}.block.{j}", k)
            if f"encoder.down.{i}.attn.{j}.q.weight" in W:
                h = ref._attn_1d(W, P, h, f"encoder.down.{i}.attn.{j}")
        if f"encoder.down.{i}.downsample.conv.weight" in W:
            h = F.conv1d(F.pad(h, (0, 1)), W[f"encoder.down.{i}.downsample.conv.weight"],
                         W[f"encoder.down.{i}.downsample.conv.bias"], stride=2)
    h = _resnet(W, h, "encoder.mid.block_1", k)
    h = ref._attn_1d(W, P, h, "encoder.mid.attn_1")
    h = _resnet(W, h, "encoder.mid.block_2", k)
    h = _conv(W, F.silu(_gn(W, h, "encoder.norm_out")), "encoder.conv_out", k)
    return _conv(W, h, "quant_conv", 1)


def posterior_sample(moments: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    mean, logvar = moments.chunk(2, dim=1)
    eps = torch.randn(mean.shape, generator=g, device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * eps


def linear_schedule(step: int, warm_up: int, f_start: float, f_max: float) -> float:
    """The single-cycle ``LambdaLinearScheduler`` inside its cycle."""
    if step < warm_up:
        return f_start + (f_max - f_start) * step / warm_up
    return f_max


@contextlib.contextmanager
def tf32(enabled: bool):
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def cfm_steps(W: Dict[str, Dict[str, torch.Tensor]], model: dict, batches: List[Dict[str, Any]],
              seed: int, lr: float, schedule: dict, device, use_tf32: bool = False,
              grad_clip: float = 1.0, betas=(0.9, 0.999), eps: float = 1e-8) -> Dict[str, Any]:
    """``len(batches)`` training steps from ``W`` (``dit``, ``vae``, ``t5``):
    each step's loss, each DiT leaf's norm of the first (clipped) gradient,
    and each leaf's norm of the change of its parameters over the steps."""
    dit_cfg = model["unet_config"]["params"]
    vae = model["first_stage_config"]["params"]
    t5p = model["cond_stage_config"]["params"]
    P = ref.Precision()
    g = torch.Generator(device=device).manual_seed(seed)
    params = {k: v.clone().requires_grad_(True) for k, v in W["dit"].items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    rope = ref._rope(dit_cfg["hidden_size"] // dit_cfg["num_heads"], dit_cfg["max_len"], device)
    losses, grad1 = [], {}
    with tf32(use_tf32):
        with torch.no_grad():
            mel0 = torch.as_tensor(batches[0]["image"], device=device, dtype=torch.float32)
            z = posterior_sample(vae_moments(W["vae"], vae["ddconfig"], mel0), g).double()
            scale = float(1.0 / torch.sqrt((z * z).mean() - z.mean() ** 2))
        for step, batch in enumerate(batches):
            with torch.no_grad():
                mel = torch.as_tensor(batch["image"], device=device, dtype=torch.float32)
                x1 = scale * posterior_sample(vae_moments(W["vae"], vae["ddconfig"], mel), g)
                ids = torch.from_numpy(ref.hash_ids(batch["caption"]["caption"],
                                                    t5p["fallback_config"]["vocab_size"],
                                                    t5p["max_length"])).to(device)
                caption = ref.t5_encode(W["t5"], t5p["fallback_config"], ids, P)
            B = x1.shape[0]
            t = torch.randint(0, 1000, (B,), generator=g, device=device)
            x0 = torch.randn(x1.shape, generator=g, device=device, dtype=torch.float32)
            ac = batch["caption"]["acoustic"]
            midi = torch.as_tensor(np.asarray(ac["midi"]), device=device)[:, 0]
            beats = torch.as_tensor(np.asarray(ac["beats"]), device=device)[:, 0]
            sigma = 1e-4
            ut = x1 - (1.0 - sigma) * x0
            tf = (t.float() / 1000.0)[:, None, None]
            x_noisy = tf * x1 + (1.0 - (1.0 - sigma) * tf) * x0
            enc = ref.dit_encode(params, dit_cfg, midi, beats, caption, P)

            def draw(shape):
                return torch.rand(shape, generator=g, device=device)

            out, lb = ref.dit_velocity(params, dit_cfg, x_noisy, t.float(), enc, rope, P,
                                       train=(step, draw))
            loss = ((out - ut) ** 2).mean(dim=(1, 2)).mean() + lb
            losses.append(float(loss.detach()))
            names = list(params)
            grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
            grads = [torch.zeros_like(params[k]) if gr is None else gr
                     for k, gr in zip(names, grads)]
            with torch.no_grad():
                norm = torch.sqrt(sum(gr.pow(2).sum() for gr in grads))
                if float(norm) >= grad_clip:
                    grads = [gr / norm * grad_clip for gr in grads]
                if step == 0:
                    grad1 = {f"dit.{k}": float(gr.norm()) for k, gr in zip(names, grads)}
                rate = float(np.float32(lr) * np.float32(linear_schedule(step, **schedule)))
                n = step + 1
                for k, gr in zip(names, grads):
                    m[k].mul_(betas[0]).add_(gr, alpha=1 - betas[0])
                    v2[k].mul_(betas[1]).addcmul_(gr, gr, value=1 - betas[1])
                    denom = (v2[k] / (1 - betas[1] ** n)).sqrt() + eps
                    params[k].sub_(rate * (m[k] / (1 - betas[0] ** n)) / denom)
    delta = {f"dit.{k}": float((params[k].detach() - start[k]).norm()) for k in params}
    return {"losses": losses, "grad1": grad1, "delta": delta, "scale": scale}
