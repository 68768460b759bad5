"""Conditional flow matching over VAE latents (port of ``versband_tpu/models/cfm.py``).

Sampling: Euler ODE integration over ``linspace(0, 1, 25)`` with
classifier-free guidance as one batch-doubled forward, t floored to an int
timestep as the reference does, and the t-independent conditioning encoded
once before the loop. The JAX ``lax.scan`` is a Python loop here; nothing in
it waits for the card, so a caller can queue several requests. The schedule
(floored timesteps and step sizes) is computed in float32 exactly as
``jnp.linspace`` and the JAX loop compute it.

Training: the OT flow-matching loss (:func:`cfm_p_losses`) plus the MoE
load-balance loss, ``t`` drawn as randint(0, 1000), latents from the frozen
VAE's posterior sample scaled by ``scale_factor`` (``scale_by_std``: 1/std of
the first batch's latents). Randomness comes from a ``torch.Generator`` or is
handed in as tensors (``noise``, ``gumbel``), so tests feed both packages the
same draws.

Conditioning: ``cond_stage_config`` builds the frozen caption tower
(``text/embedders.py``, the shipped ``TextVocalEmbedder``) on the model's
device, and :meth:`LatentDiffusion.get_learned_conditioning` turns a cond
dict with caption strings into one with caption embeddings. The trainer
runs the same tower on each step's captions (``train/trainer.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from versband_tpu_torch import parallel
from versband_tpu_torch.device import DeviceLike, resolve_device
from versband_tpu_torch.models.dit import BandMoeDiT, GumbelSource
from versband_tpu_torch.models.schedules import (
    DiffusionSchedule, make_ddim_sampling_parameters, make_ddim_timesteps)
from versband_tpu_torch.nn.rounding import cast_module
from versband_tpu_torch.utils.config import instantiate_from_config


def _cond_to_context(cond: Dict[str, Any]) -> Dict[str, Any]:
    """``{'caption': z, 'acoustic': {...}}`` -> the DiT context dict; non-tensor entries dropped."""
    acoustic = {k: v for k, v in cond["acoustic"].items() if torch.is_tensor(v)}
    return {"c_crossattn": cond["caption"], "c_concat": acoustic}


def cfm_p_losses(model: nn.Module, x_start: torch.Tensor, cond: Dict[str, Any],
                 t: torch.Tensor, noise: torch.Tensor, *, sigma_min: float = 1e-4,
                 num_timesteps: int = 1000, l_simple_weight: float = 1.0, step: int = 0,
                 gumbel: Optional[GumbelSource] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """OT-CFM loss. ``x_start``: [B, C, T] latents (x1); ``noise``: x0;
    ``t``: int [B] in [0, num_timesteps). Training routing (soft, Gumbel noise
    from ``gumbel``) when ``gumbel`` is given, eval routing otherwise, as the
    JAX function ties ``train`` to its Gumbel key. Only the Band-MoE DiT
    draws Gumbel noise; the legacy backbones route by hard rules and answer
    ``(out, 0.0)``, whose 0.0 becomes a tensor here (flax's ``apply`` ignores
    the unused ``gumbel`` rng, and jnp takes the float)."""
    x1, x0 = x_start, noise
    ut = x1 - (1.0 - sigma_min) * x0
    t_frac = (t.float() / num_timesteps)[:, None, None]
    x_noisy = t_frac * x1 + (1.0 - (1.0 - sigma_min) * t_frac) * x0
    draws = {"gumbel": gumbel} if isinstance(model, BandMoeDiT) else {}
    model_out, lb_loss = model(x_noisy, t, _cond_to_context(cond), step=step,
                               train=gumbel is not None, **draws)
    lb_loss = torch.as_tensor(lb_loss, dtype=model_out.dtype, device=model_out.device)
    loss_simple = ((model_out - ut) ** 2).mean(dim=tuple(range(1, ut.ndim)))
    loss = l_simple_weight * loss_simple.mean() + lb_loss
    return loss, {"loss_simple": loss_simple.mean(), "lb_loss": lb_loss, "loss": loss}


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
    """Frozen VAE first stage + trainable backbone, built from the reference
    YAML's ``model.params`` on ``device`` in ``dtype``. The training keys are
    kept (``scale_by_std``, ``l_simple_weight``, the beta schedule, and
    ``use_ema`` and ``scheduler_config``, which :class:`CFMTrainer` reads);
    keys that neither sampling nor training reads are accepted and ignored.

    ``cond_stage_config`` builds the frozen caption tower on ``device`` (in
    fp32, whatever ``dtype``). Unlike JAX (``models/cfm.py:197-204``), a
    cond stage that fails to build raises instead of leaving
    ``cond_stage = None``: a tower that silently vanished would leave the
    captions unencoded."""

    def __init__(self, unet_config=None, first_stage_config=None, cond_stage_config=None,
                 timesteps: int = 1000,
                 beta_schedule: str = "linear", linear_start: float = 0.00085,
                 linear_end: float = 0.012, cosine_s: float = 8e-3,
                 mel_dim: int = 20, mel_length: int = 750, first_stage_key: str = "image",
                 cond_stage_key: str = "caption", conditioning_key: str = "hybrid",
                 scale_by_std: bool = True, scale_factor: float = 1.0,
                 use_ema: bool = False, scheduler_config=None, l_simple_weight: float = 1.0,
                 device: DeviceLike = None, dtype: torch.dtype = torch.float32, **kwargs):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.schedule = DiffusionSchedule.create(timesteps, beta_schedule, linear_start,
                                                 linear_end, cosine_s)
        self.num_timesteps = timesteps
        self.mel_dim = mel_dim
        self.mel_length = mel_length
        self.first_stage_key = first_stage_key
        self.cond_stage_key = cond_stage_key
        self.conditioning_key = conditioning_key
        self.scale_by_std = scale_by_std
        self.scale_factor = float(scale_factor)
        self.use_ema = use_ema
        self.scheduler_config = scheduler_config
        self.l_simple_weight = l_simple_weight
        self.model = self._build(unet_config)
        self.first_stage = self._build(first_stage_config)
        if self.first_stage is not None:
            self.first_stage.requires_grad_(False)  # frozen: never trained here
        self.cond_stage = None
        if cond_stage_config and cond_stage_config != "__is_unconditional__":
            self.cond_stage = instantiate_from_config(cond_stage_config, device=self.device)

    def _build(self, config) -> Optional[nn.Module]:
        """The module of ``config``, its weights made and initialised on the
        model's device (a 5 B-parameter backbone takes ~50 s to initialise on
        the host), then cast to its dtype (norms kept in float32, as flax
        keeps them: ``nn/rounding.py``)."""
        if not config:
            return None
        with torch.device(self.device):
            module = instantiate_from_config(config)
        return cast_module(module.to(self.device), self.dtype).eval()

    def apply_model(self, x_noisy: torch.Tensor, t: torch.Tensor, cond: Dict[str, Any],
                    step: int = 0, train: bool = False, **kw) -> Tuple[torch.Tensor, Any]:
        """The backbone's ``(out, aux)`` on a cond dict; ``kw`` (the Band-MoE
        DiT's ``gumbel``) is handed on."""
        return self.model(x_noisy, t, _cond_to_context(cond), step=step, train=train, **kw)

    @torch.no_grad()
    def encode_first_stage(self, mel: torch.Tensor, generator: Optional[torch.Generator] = None,
                           sample: bool = True, noise: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """[B, 80, T] mel -> scaled latent [B, 20, T/2]: the posterior sample
        (from ``generator``, or ``mean + std * noise``) or its mode."""
        post = self.first_stage.encode(mel)
        draw = sample and (generator is not None or noise is not None)
        z = post.sample(generator, noise) if draw else post.mode()
        return self.scale_factor * z

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.first_stage.decode(z / self.scale_factor)

    @torch.no_grad()
    def compute_scale_factor(self, mel: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             noise: Optional[torch.Tensor] = None, group=None) -> float:
        """scale_by_std: 1/std(z) of a posterior sample of ``mel`` (population
        std), over every rank's ``mel`` under a process group: the sums of z
        and z^2 in float64, summed over the ranks of ``group`` (None: all of
        them; under a mesh, the data group)."""
        z = self.first_stage.encode(mel).sample(generator, noise).double()
        n, s1, s2 = parallel.global_sum(torch.stack(
            [z.new_tensor(float(z.numel())), z.sum(), (z * z).sum()]), group)
        std = torch.sqrt(s2 / n - (s1 / n) ** 2)
        self.scale_factor = float(1.0 / std.item())
        return self.scale_factor

    def get_loss(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """The elementwise squared error."""
        return (pred - target) ** 2

    def latent_length(self, cond_length: int) -> int:
        """ceil(T_cond / 2): latent frames for a conditioning of T mel frames."""
        return math.ceil(cond_length / 2)

    def get_learned_conditioning(self, cond: Any) -> Any:
        """The cond dict with its captions encoded by the cond stage (or, for
        a text cond stage, the encoded texts), cast to the model's dtype; as
        it is without a cond stage."""
        if self.cond_stage is None:
            return cond
        out = self.cond_stage(cond)
        if not isinstance(out, dict):
            return out.to(self.dtype)
        return {**out, "caption": out["caption"].to(self.dtype)}


class CFM(LatentDiffusion):
    """Flow-matching latent model: the training loss and CFG Euler sampling."""

    sigma_min: float = 1e-4

    def p_losses(self, x_start: torch.Tensor, cond: Dict[str, Any], t: torch.Tensor,
                 generator: Optional[torch.Generator] = None, step: int = 0,
                 train: bool = True, noise: Optional[torch.Tensor] = None,
                 gumbel: Optional[GumbelSource] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The CFM loss at timesteps ``t``. ``noise`` (x0) is drawn from
        ``generator`` unless given; in training mode the Gumbel noise comes
        from ``gumbel`` if given, else from ``generator``."""
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                dtype=x_start.dtype)
        if not train:
            gumbel = None
        elif gumbel is None:
            gumbel = generator
        return cfm_p_losses(self.model, x_start, cond, t, noise, sigma_min=self.sigma_min,
                            num_timesteps=self.num_timesteps,
                            l_simple_weight=self.l_simple_weight, step=step, gumbel=gumbel)

    def training_losses(self, x_start: torch.Tensor, cond: Dict[str, Any],
                        generator: Optional[torch.Generator] = None, step: int = 0
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Draw t ~ randint(0, num_timesteps) and compute the CFM loss."""
        t = torch.randint(0, self.num_timesteps, (x_start.shape[0],), generator=generator,
                          device=x_start.device)
        return self.p_losses(x_start, cond, t, generator, step=step)

    def stochastic_encode(self, x0: torch.Tensor, t_index: int,
                          generator: Optional[torch.Generator] = None, ddim_steps: int = 25,
                          noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Partial-noise start for img2img-style sampling: sqrt(a) x0 +
        sqrt(1 - a) noise at DDIM step ``t_index`` of a uniform schedule."""
        ddim_ts = make_ddim_timesteps("uniform", ddim_steps, self.num_timesteps)
        _, alphas, _ = make_ddim_sampling_parameters(self.schedule.alphas_cumprod, ddim_ts,
                                                     eta=0.0)
        a = torch.from_numpy(alphas).to(x0.device)[t_index]
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                                dtype=x0.dtype)
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise

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
