"""Conditional flow matching over VAE latents: the sampling half
(port of ``versband_tpu/models/cfm.py``).

Euler ODE integration over ``linspace(0, 1, 25)`` with classifier-free
guidance as one batch-doubled forward, t floored to an int timestep as the
reference does, and the t-independent conditioning encoded once before the
loop. The JAX ``lax.scan`` is a Python loop here; nothing in it waits for the
card, so a caller can queue several requests. The schedule (floored
timesteps and step sizes) is computed in float32 exactly as ``jnp.linspace``
and the JAX loop compute it.

The training half (``p_losses``, ``stochastic_encode``, the diffusion
schedules) and the text tower (``cond_stage_config``) are not ported yet:
callers pass caption embeddings.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from versband_tpu_torch.device import DeviceLike, resolve_device
from versband_tpu_torch.models.dit import BandMoeDiT
from versband_tpu_torch.utils.config import instantiate_from_config


def _cond_to_context(cond: Dict[str, Any]) -> Dict[str, Any]:
    """``{'caption': z, 'acoustic': {...}}`` -> the DiT context dict; non-tensor entries dropped."""
    acoustic = {k: v for k, v in cond["acoustic"].items() if torch.is_tensor(v)}
    return {"c_crossattn": cond["caption"], "c_concat": acoustic}


def _tree_concat(a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _tree_concat(a[k], b[k]) for k in a}
    return torch.cat([a, b], dim=0)


def euler_schedule(num_steps: int = 25, t_start: int = 0, num_timesteps: int = 1000
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The floored model timesteps and the step sizes of the Euler loop, float32.

    ``jnp.linspace(0, 1, n)`` is ``0*(1-s) + 1*s`` with ``s = i / (n-1)`` in
    float32, which XLA compiles as ``i * float32(1/(n-1))`` (a division by a
    constant becomes a multiply by its reciprocal), plus an exact endpoint;
    the loop then takes ``floor(ts[i] * num_timesteps)`` and ``ts[i+1] - ts[i]``.
    """
    f32 = np.float32
    div = num_steps - 1
    s = np.arange(div, dtype=f32) * (f32(1.0) / f32(div))
    ts = np.concatenate([s, [f32(1.0)]]).astype(f32)
    ts = ts[t_start:]
    t_int = np.floor(ts[:-1] * f32(num_timesteps)).astype(f32)
    dt = (ts[1:] - ts[:-1]).astype(f32)
    return t_int, dt


@torch.no_grad()
def euler_cfg_sample(model: nn.Module, x0: torch.Tensor, cond: Dict[str, Any],
                     uncond: Optional[Dict[str, Any]] = None, guidance_scale: float = 1.0,
                     num_steps: int = 25, t_start: int = 0, num_timesteps: int = 1000,
                     encode_once: bool = False) -> torch.Tensor:
    """Euler integration of the flow field with CFG; ``x0`` [B, C, T] start noise.

    ``encode_once`` hoists the conditioning encode (midi/beats stems, caption
    projection) out of the loop, for backbones that answer
    ``{"encode_only": True}`` (BandMoeDiT).
    """
    B = x0.shape[0]
    use_cfg = uncond is not None and guidance_scale != 1.0
    ctx = _cond_to_context(cond)
    if use_cfg:
        ctx = _tree_concat(ctx, _cond_to_context(uncond))
    n = 2 * B if use_cfg else B
    if encode_once:
        enc = model(torch.zeros((n,) + tuple(x0.shape[1:]), dtype=x0.dtype, device=x0.device),
                    torch.zeros((n,), dtype=torch.float32, device=x0.device),
                    {**ctx, "encode_only": True})
        ctx = {"c_encoded": enc}
    t_int, dt = euler_schedule(num_steps, t_start, num_timesteps)
    x = x0
    for i in range(len(dt)):
        t_in = torch.full((n,), float(t_int[i]), dtype=torch.float32, device=x0.device)
        if use_cfg:
            v, _ = model(torch.cat([x, x], dim=0), t_in, ctx)
            v_c, v_u = v.chunk(2, dim=0)
            v = v_u + guidance_scale * (v_c - v_u)
        else:
            v, _ = model(x, t_in, ctx)
        # fp32 step as in the JAX loop (its dt is a float32 array)
        x = (x.float() + float(dt[i]) * v.float()).to(x0.dtype)
    return x


class LatentDiffusion:
    """Frozen VAE first stage + backbone, built from the reference YAML's
    ``model.params`` on ``device`` in ``dtype``. Keys of the training config
    that the sampler does not use are accepted and ignored."""

    def __init__(self, unet_config=None, first_stage_config=None, timesteps: int = 1000,
                 mel_dim: int = 20, scale_factor: float = 1.0,
                 device: DeviceLike = None, dtype: torch.dtype = torch.float32, **kwargs):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.num_timesteps = timesteps
        self.mel_dim = mel_dim
        self.scale_factor = float(scale_factor)
        self.model = self._build(unet_config)
        self.first_stage = self._build(first_stage_config)

    def _build(self, config) -> Optional[nn.Module]:
        if not config:
            return None
        return instantiate_from_config(config).to(device=self.device, dtype=self.dtype).eval()

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.first_stage.decode(z / self.scale_factor)

    def latent_length(self, cond_length: int) -> int:
        """ceil(T_cond / 2): latent frames for a conditioning of T mel frames."""
        return math.ceil(cond_length / 2)


class CFM(LatentDiffusion):
    """Flow-matching latent model: CFG Euler sampling."""

    def sample_cfg(self, cond: Dict[str, Any], guidance_scale: float,
                   uncond: Optional[Dict[str, Any]] = None,
                   generator: Optional[torch.Generator] = None,
                   batch_size: Optional[int] = None, timesteps: Optional[int] = None,
                   shape: Optional[Tuple[int, ...]] = None,
                   x_latent: Optional[torch.Tensor] = None, t_start: int = 0) -> torch.Tensor:
        """Latent length derives from the acoustic cond; start noise is float32
        normal from ``generator`` unless ``x_latent`` is given."""
        steps = 25 if timesteps is None else timesteps
        if shape is None:
            ac = cond["acoustic"]
            ref = next(ac[k] for k in ("acoustic", "midi", "beats") if ac.get(k) is not None)
            shape = (batch_size or ref.shape[0], self.mel_dim, self.latent_length(ref.shape[2]))
        x0 = x_latent if x_latent is not None else torch.randn(
            shape, generator=generator, device=self.device, dtype=torch.float32)
        return euler_cfg_sample(self.model, x0, cond, uncond, guidance_scale,
                                num_steps=steps, t_start=t_start,
                                num_timesteps=self.num_timesteps,
                                encode_once=isinstance(self.model, BandMoeDiT))

    def sample(self, cond: Dict[str, Any], generator: Optional[torch.Generator] = None,
               **kw) -> torch.Tensor:
        return self.sample_cfg(cond, 1.0, None, generator, **kw)


class CFMSampler:
    """Standalone inference sampler with a fixed step count."""

    def __init__(self, model: CFM, num_timesteps: int = 25):
        self.model = model
        self.num_timesteps = num_timesteps

    def sample_cfg(self, cond, guidance_scale, uncond=None, generator=None,
                   batch_size=None, shape=None, x_latent=None, t_start: int = 0):
        return self.model.sample_cfg(cond, guidance_scale, uncond, generator,
                                     batch_size=batch_size, timesteps=self.num_timesteps,
                                     shape=shape, x_latent=x_latent, t_start=t_start)
