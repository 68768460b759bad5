"""Classic diffusion samplers over the DDPM schedule buffers (port of
``versband_tpu/models/samplers.py``).

* ``q_sample``, ``predict_start_from_noise``, ``q_posterior`` and the DDPM
  training loss ``ddpm_p_losses`` (eps or x0, with the VLB weight);
* ``ddpm_sample_loop``: ancestral sampling from T-1 down to 0;
* ``DDIMSampler``: ``make_schedule``, ``sample`` with batch-doubled CFG and
  ``eta``, ``stochastic_encode`` and ``decode``;
* ``PLMSSampler``: pseudo linear multistep, its order-ramp warm-up (an Euler
  step with a second model call, then the 2nd- and 3rd-order forms) outside
  the 4th-order loop, as JAX runs it outside its scan.

Model contract everywhere: ``model(x, t, context) -> (eps, aux)``, ``t`` a
float32 vector. The JAX ``lax.scan`` loops are Python loops here.

Every coefficient is taken from the float32 tables (``DiffusionSchedule``
holds them in float32, as JAX reads its numpy tables with x64 off) and the
arithmetic on them is float32. The loops read their per-step coefficients
on the host, so a step queues only the model and a few elementwise kernels.

Randomness: each sampler draws from a ``torch.Generator`` (on the device of
the samples), or takes its draws handed in: the start noise ``x_T`` and
``noise``, a callable from the loop's step index to that step's draw (JAX
draws it from ``fold_in(k_loop, step)``). A sampler run without grad
(``torch.no_grad``); ``ddpm_p_losses`` keeps the graph for training.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from versband_tpu_torch.models.cfm import _tree_concat
from versband_tpu_torch.models.schedules import (
    DiffusionSchedule, make_ddim_sampling_parameters, make_ddim_timesteps)

Model = Callable[..., Tuple[torch.Tensor, Any]]
StepNoise = Callable[[int], torch.Tensor]
F32 = np.float32


def _extract(table: np.ndarray, t, like: torch.Tensor):
    """``table[t]``: for an int ``t`` the float32 value as a Python float
    (read on the host), for an int tensor ``t`` [B] a gather shaped to
    broadcast over ``like`` ([B, 1, ...])."""
    if isinstance(t, (int, np.integer)):
        return float(table[t])
    out = torch.from_numpy(np.ascontiguousarray(table)).to(like.device)[t.long()]
    return out.reshape(out.shape + (1,) * (like.ndim - 1))


def normal_like(generator: Optional[torch.Generator], like: torch.Tensor) -> torch.Tensor:
    return torch.randn(like.shape, generator=generator, device=like.device, dtype=torch.float32)


def _step_noise(noise: Optional[StepNoise], generator, like: torch.Tensor, step: int):
    return noise(step) if noise is not None else normal_like(generator, like)


def q_sample(schedule: DiffusionSchedule, x_start: torch.Tensor, t,
             noise: torch.Tensor) -> torch.Tensor:
    """x_t = sqrt(ac_t) x0 + sqrt(1 - ac_t) eps (``ddpm.py:281-289``)."""
    return (_extract(schedule.sqrt_alphas_cumprod, t, x_start) * x_start
            + _extract(schedule.sqrt_one_minus_alphas_cumprod, t, x_start) * noise)


def predict_start_from_noise(schedule: DiffusionSchedule, x_t: torch.Tensor, t,
                             noise: torch.Tensor) -> torch.Tensor:
    return (_extract(schedule.sqrt_recip_alphas_cumprod, t, x_t) * x_t
            - _extract(schedule.sqrt_recipm1_alphas_cumprod, t, x_t) * noise)


def q_posterior(schedule: DiffusionSchedule, x_start: torch.Tensor, x_t: torch.Tensor,
                t) -> Tuple[torch.Tensor, Any, Any]:
    mean = (_extract(schedule.posterior_mean_coef1, t, x_t) * x_start
            + _extract(schedule.posterior_mean_coef2, t, x_t) * x_t)
    var = _extract(schedule.posterior_variance, t, x_t)
    log_var = _extract(schedule.posterior_log_variance_clipped, t, x_t)
    return mean, var, log_var


def lvlb_weights(schedule: DiffusionSchedule) -> np.ndarray:
    """The eps-parameterization VLB weights (``ddpm.py:160-167``) in float32;
    index 0 takes index 1's value (``posterior_variance[0]`` is 0, so the
    division gives inf there)."""
    betas, ac, pv = schedule.betas, schedule.alphas_cumprod, schedule.posterior_variance
    with np.errstate(divide="ignore"):
        w = betas ** 2 / (F32(2) * pv * (F32(1) - betas) * (F32(1) - ac))
    w[0] = w[1]
    return w.astype(F32)


def ddpm_p_losses(model: Model, schedule: DiffusionSchedule, x_start: torch.Tensor,
                  t: torch.Tensor, context, noise: torch.Tensor,
                  parameterization: str = "eps", loss_type: str = "l2",
                  l_simple_weight: float = 1.0, original_elbo_weight: float = 0.0
                  ) -> Tuple[torch.Tensor, dict]:
    """The classic DDPM loss (``ddpm.py:290-340``): q_sample, predict eps (or
    x0), per-item MSE (or L1), plus the VLB term weighted by ``lvlb_weights``."""
    x_noisy = q_sample(schedule, x_start, t, noise)
    out, _ = model(x_noisy, t.float(), context)
    target = noise if parameterization == "eps" else x_start
    err = (out - target) ** 2 if loss_type == "l2" else (out - target).abs()
    loss_simple = err.mean(dim=tuple(range(1, err.ndim)))
    w = torch.from_numpy(lvlb_weights(schedule)).to(x_start.device)[t.long()]
    loss_vlb = (w * loss_simple).mean()
    loss = l_simple_weight * loss_simple.mean() + original_elbo_weight * loss_vlb
    return loss, {"loss_simple": loss_simple.mean(), "loss_vlb": loss_vlb, "loss": loss}


def ancestral_step(schedule: DiffusionSchedule, x: torch.Tensor, out: torch.Tensor, step: int,
                   noise: Callable[[], torch.Tensor], parameterization: str = "eps",
                   clip_denoised: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the ancestral loop at timestep ``step``: (x_{t-1}, x0).
    ``noise()`` is called at every step, as JAX draws at every step; its draw
    is masked at step 0."""
    x0 = predict_start_from_noise(schedule, x, step, out) if parameterization == "eps" else out
    if clip_denoised:
        x0 = x0.clamp(-1.0, 1.0)
    mean, _, log_var = q_posterior(schedule, x0, x, step)
    z = noise()
    if step == 0:
        return mean, x0
    return mean + float(np.exp(F32(0.5) * F32(log_var))) * z, x0


@torch.no_grad()
def ddpm_sample_loop(model: Model, schedule: DiffusionSchedule, shape: Tuple[int, ...],
                     context, generator: Optional[torch.Generator] = None,
                     parameterization: str = "eps", clip_denoised: bool = True,
                     x_T: Optional[torch.Tensor] = None, noise: Optional[StepNoise] = None,
                     device=None) -> torch.Tensor:
    """Ancestral sampling from T-1 down to 0 (``ddpm.py:489-530``); start
    noise ``x_T`` of ``shape`` and per-step draws ``noise(step)`` from
    ``generator`` unless given."""
    if x_T is None:
        x_T = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    x = x_T
    B = shape[0]
    for step in range(schedule.num_timesteps - 1, -1, -1):
        t = torch.full((B,), float(step), dtype=torch.float32, device=x.device)
        out, _ = model(x, t, context)
        x, _ = ancestral_step(schedule, x, out, step,
                              lambda: _step_noise(noise, generator, x, step),
                              parameterization, clip_denoised)
    return x


def cfg_eps(model: Model, x: torch.Tensor, t_vec: torch.Tensor, context, uncond_context,
            scale: float) -> torch.Tensor:
    """Batch-doubled classifier-free guidance: one forward over
    ``[x, x]`` with the context trees concatenated leaf by leaf
    (``samplers.py:119-131``)."""
    if uncond_context is None or scale == 1.0:
        eps, _ = model(x, t_vec, context)
        return eps
    eps2, _ = model(torch.cat([x, x], dim=0), torch.cat([t_vec, t_vec], dim=0),
                    _tree_concat(context, uncond_context))
    eps_c, eps_u = eps2.chunk(2, dim=0)
    return eps_u + scale * (eps_c - eps_u)


def _ddim_update(x: torch.Tensor, eps: torch.Tensor, a_t, a_prev, sigma_t=F32(0),
                 clip_denoised: bool = False, noise: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """x_prev = sqrt(a_prev) x0 + sqrt(max(1 - a_prev - sigma^2, 0)) eps + sigma z,
    with every coefficient a float32 scalar."""
    pred_x0 = (x - float(np.sqrt(F32(1) - a_t)) * eps) / float(np.sqrt(a_t))
    if clip_denoised:
        pred_x0 = pred_x0.clamp(-1.0, 1.0)
    dir_xt = float(np.sqrt(np.maximum(F32(1) - a_prev - sigma_t * sigma_t, F32(0)))) * eps
    out = float(np.sqrt(a_prev)) * pred_x0 + dir_xt
    if noise is not None:
        out = out + float(sigma_t) * noise
    return out


class DDIMSampler:
    """``ldm/models/diffusion/ddim.py:25-233`` over the float32 tables."""

    def __init__(self, model: Model, schedule: DiffusionSchedule):
        self.model = model
        self.schedule = schedule

    def make_schedule(self, ddim_num_steps: int, ddim_discretize: str = "uniform",
                      ddim_eta: float = 0.0):
        """(timesteps, sigmas, alphas, alphas_prev), the last three float32."""
        ts = make_ddim_timesteps(ddim_discretize, ddim_num_steps, self.schedule.num_timesteps)
        ts = np.minimum(ts, self.schedule.num_timesteps - 1)
        sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
            self.schedule.alphas_cumprod, ts, ddim_eta)
        return ts, sigmas, alphas, alphas_prev

    @torch.no_grad()
    def sample(self, shape: Tuple[int, ...], context, generator: Optional[torch.Generator] = None,
               S: int = 50, eta: float = 0.0, unconditional_guidance_scale: float = 1.0,
               unconditional_conditioning=None, x_T: Optional[torch.Tensor] = None,
               clip_denoised: bool = False, noise: Optional[StepNoise] = None,
               device=None) -> torch.Tensor:
        """DDIM over ``S`` uniform steps; ``noise(i)`` is the draw of loop
        index ``i`` (S-1 down to 0), taken only where sigma_i != 0."""
        ts, sigmas, alphas, alphas_prev = self.make_schedule(S, ddim_eta=eta)
        x = x_T if x_T is not None else torch.randn(shape, generator=generator, device=device,
                                                    dtype=torch.float32)
        B = shape[0]
        for i in range(len(ts) - 1, -1, -1):
            t_vec = torch.full((B,), float(ts[i]), dtype=torch.float32, device=x.device)
            eps = cfg_eps(self.model, x, t_vec, context, unconditional_conditioning,
                          unconditional_guidance_scale)
            z = _step_noise(noise, generator, x, i) if sigmas[i] != 0 else None
            x = _ddim_update(x, eps, alphas[i], alphas_prev[i], sigmas[i], clip_denoised, z)
        return x

    def stochastic_encode(self, x0: torch.Tensor, t_index: int,
                          generator: Optional[torch.Generator] = None,
                          ddim_num_steps: int = 50, noise: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """sqrt(a) x0 + sqrt(1 - a) noise at DDIM index ``t_index``."""
        _, _, alphas, _ = self.make_schedule(ddim_num_steps)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
        a = alphas[t_index]
        return float(np.sqrt(a)) * x0 + float(np.sqrt(F32(1) - a)) * noise

    @torch.no_grad()
    def decode(self, x_latent: torch.Tensor, context, t_start: int, S: int = 50,
               unconditional_guidance_scale: float = 1.0, unconditional_conditioning=None
               ) -> torch.Tensor:
        """Deterministic DDIM (sigma 0) from an encoded latent, over indices
        ``t_start - 1`` down to 0 (``ddim.py:196-233``)."""
        ts, _, alphas, alphas_prev = self.make_schedule(S)
        B = x_latent.shape[0]
        x = x_latent
        for i in range(t_start - 1, -1, -1):
            t_vec = torch.full((B,), float(ts[i]), dtype=torch.float32, device=x.device)
            eps = cfg_eps(self.model, x, t_vec, context, unconditional_conditioning,
                          unconditional_guidance_scale)
            x = _ddim_update(x, eps, alphas[i], alphas_prev[i])
        return x


class PLMSSampler:
    """Pseudo linear multistep sampler (``plms.py:11-236``)."""

    def __init__(self, model: Model, schedule: DiffusionSchedule):
        self.model = model
        self.schedule = schedule

    @torch.no_grad()
    def sample(self, shape: Tuple[int, ...], context, generator: Optional[torch.Generator] = None,
               S: int = 50, unconditional_guidance_scale: float = 1.0,
               unconditional_conditioning=None, x_T: Optional[torch.Tensor] = None,
               device=None) -> torch.Tensor:
        """S + 1 model calls: the warm-up's first step calls twice. JAX draws
        ``x_T`` from the sampler's key itself, not a split of it."""
        ts = make_ddim_timesteps("uniform", S, self.schedule.num_timesteps)
        ts = np.minimum(ts, self.schedule.num_timesteps - 1)
        _, alphas, alphas_prev = make_ddim_sampling_parameters(
            self.schedule.alphas_cumprod, ts, eta=0.0)
        B = shape[0]
        x = x_T if x_T is not None else torch.randn(shape, generator=generator, device=device,
                                                    dtype=torch.float32)

        def eps_at(x, i):
            t_vec = torch.full((B,), float(ts[i]), dtype=torch.float32, device=x.device)
            return cfg_eps(self.model, x, t_vec, context, unconditional_conditioning,
                           unconditional_guidance_scale)

        def x_prev_from(x, e, i):
            return _ddim_update(x, e, alphas[i], alphas_prev[i])

        n = len(ts)
        old_eps = []
        idx = n - 1
        for k in range(min(3, n)):  # warm-up, orders 1..3
            e_t = eps_at(x, idx)
            if k == 0:  # Euler step, then the mean of this eps and the next one
                e_next = eps_at(x_prev_from(x, e_t, idx), max(idx - 1, 0))
                e_prime = 0.5 * (e_t + e_next)
            elif k == 1:
                e_prime = (3.0 * e_t - old_eps[-1]) / 2.0
            else:
                e_prime = (23.0 * e_t - 16.0 * old_eps[-1] + 5.0 * old_eps[-2]) / 12.0
            x = x_prev_from(x, e_prime, idx)
            old_eps.append(e_t)
            idx -= 1
            if idx < 0:
                return x
        ring = old_eps[-3:]  # newest last
        for i in range(idx, -1, -1):  # 4th-order Adams-Bashforth
            e_t = eps_at(x, i)
            e_prime = (55.0 * e_t - 59.0 * ring[2] + 37.0 * ring[1] - 9.0 * ring[0]) / 24.0
            x = x_prev_from(x, e_prime, i)
            ring = ring[1:] + [e_t]
        return x
