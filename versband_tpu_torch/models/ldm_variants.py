"""The conditioning dispatch and the legacy LDM variants (port of
``versband_tpu/models/ldm_variants.py``).

* ``diffusion_wrapper_apply``: the ``DiffusionWrapper`` dispatch over the
  conditioning modes None, concat, crossattn, hybrid, adm and film;
* ``progressive_denoising`` (ancestral sampling with x0 snapshots) and
  ``inpaint_sample`` (the known region re-noised into every step);
* ``clap_rerank``, ``NoiseLevelClassifier`` and ``classifier_guided_eps``
  (ADM guidance, its gradient through ``torch.autograd.grad``);
* the LDMs ``LatentDiffusionInpaint`` (hybrid conditioning, the classic DDPM
  loss, DDIM sampling), ``AudioLDM`` (best-of-N generation reranked by CLAP)
  and ``LatentDiffusionOrder`` (single-key dispatch).

Backbones are called ``model(x, t, context)`` and answer ``(out, aux)``.
Draws come from a ``torch.Generator`` or are handed in (``x_T`` and a
callable ``noise(step)``), as in :mod:`versband_tpu_torch.models.samplers`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from versband_tpu_torch.models.cfm import LatentDiffusion
from versband_tpu_torch.models.samplers import (
    DDIMSampler, PLMSSampler, StepNoise, ancestral_step, ddpm_p_losses, normal_like, q_sample)
from versband_tpu_torch.models.schedules import DiffusionSchedule
from versband_tpu_torch.nn.core import TimestepEmbedder

Model = Callable[..., Tuple[torch.Tensor, Any]]


def diffusion_wrapper_apply(model: Model, x: torch.Tensor, t: torch.Tensor,
                            conditioning_key: Optional[str] = None, c_concat: Any = None,
                            c_crossattn: Any = None):
    """Conditioning-mode dispatch (``ddpm.py:1403-1436``) onto
    ``model(x, t, context)``."""
    if conditioning_key is None:
        return model(x, t, None)
    if conditioning_key == "concat":
        parts = list(c_concat) if isinstance(c_concat, (list, tuple)) else [c_concat]
        return model(torch.cat([x] + parts, dim=1), t, None)
    if conditioning_key == "crossattn":
        return model(x, t, c_crossattn)
    if conditioning_key == "hybrid":
        return model(x, t, {"c_concat": c_concat, "c_crossattn": c_crossattn})
    if conditioning_key in ("adm", "film"):
        return model(x, t, c_crossattn)
    raise NotImplementedError(conditioning_key)


@torch.no_grad()
def progressive_denoising(model: Model, schedule: DiffusionSchedule, shape: Tuple[int, ...],
                          context, generator: Optional[torch.Generator] = None,
                          n_snapshots: int = 10, parameterization: str = "eps",
                          x_T: Optional[torch.Tensor] = None, noise: Optional[StepNoise] = None,
                          device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ancestral sampling (x0 clipped) that also returns the x0 predictions
    of every ``max(T // n_snapshots, 1)``-th step, at most ``n_snapshots``:
    (x_final, snapshots [S, B, ...]) (``ddpm_audio.py:560-652``)."""
    T = schedule.num_timesteps
    x = x_T if x_T is not None else torch.randn(shape, generator=generator, device=device,
                                                dtype=torch.float32)
    snap_every = max(T // n_snapshots, 1)
    snaps = []
    for k, step in enumerate(range(T - 1, -1, -1)):
        t = torch.full((shape[0],), float(step), dtype=torch.float32, device=x.device)
        out, _ = model(x, t, context)
        draw = (lambda: noise(step)) if noise is not None else (lambda: normal_like(generator, x))
        x, x0 = ancestral_step(schedule, x, out, step, draw, parameterization, clip_denoised=True)
        if k % snap_every == 0 and len(snaps) < n_snapshots:
            snaps.append(x0)
    return x, torch.stack(snaps)


@torch.no_grad()
def inpaint_sample(model: Model, schedule: DiffusionSchedule, x0_known: torch.Tensor,
                   mask: torch.Tensor, context, generator: Optional[torch.Generator] = None,
                   parameterization: str = "eps", x_T: Optional[torch.Tensor] = None,
                   noise: Optional[Callable[[int], Tuple[torch.Tensor, torch.Tensor]]] = None
                   ) -> torch.Tensor:
    """Masked-latent inpainting: at every ancestral step the known region
    (mask 1) is replaced by the ground truth diffused to that step. Each step
    takes two draws, ``noise(step) -> (renoise, posterior)``."""
    x = x_T if x_T is not None else normal_like(generator, x0_known)
    B = x0_known.shape[0]
    for step in range(schedule.num_timesteps - 1, -1, -1):
        z1, z2 = noise(step) if noise is not None else (normal_like(generator, x),
                                                        normal_like(generator, x))
        x = mask * q_sample(schedule, x0_known, step, z1) + (1.0 - mask) * x
        t = torch.full((B,), float(step), dtype=torch.float32, device=x.device)
        out, _ = model(x, t, context)
        x, _ = ancestral_step(schedule, x, out, step, lambda: z2, parameterization,
                              clip_denoised=False)
    return mask * x0_known + (1.0 - mask) * x


def _numpy(a) -> np.ndarray:
    return a.detach().float().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def clap_rerank(samples_wav, caption: str, clap, top_k: int = 1) -> np.ndarray:
    """Indices of the ``top_k`` waveforms by CLAP text-audio similarity to
    ``caption`` (``audioldm.py:236-243``)."""
    a = clap.get_audio_embeddings(samples_wav)
    t = clap.get_text_embeddings([caption])
    sims = _numpy(clap.compute_similarity(a, t))[:, 0]
    return np.argsort(sims)[::-1][:top_k]


def same_pad(n: int, kernel: int, stride: int) -> Tuple[int, int]:
    """The (low, high) padding of a ``padding="SAME"`` convolution over ``n``
    frames: the total ``(ceil(n / s) - 1) s + k - n`` split with the odd
    frame on the high side (``nn.Conv1d(padding=k // 2)`` pads evenly)."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class NoiseLevelClassifier(nn.Module):
    """Noisy-latent classifier for guidance: ``depth`` stride-2 convs (kernel
    5, SAME padding) over [B, C, T] latents, each followed by SiLU of the
    conv plus the timestep embedding, a mean over time and a linear head.
    Parameter names are JAX's (``t_embedder``, ``conv_{i}``, ``out``)."""

    def __init__(self, num_classes: int, in_channels: int = 20, hidden: int = 128,
                 depth: int = 3):
        super().__init__()
        self.depth = depth
        self.t_embedder = TimestepEmbedder(hidden)
        for i in range(depth):
            self.add_module(f"conv_{i}", nn.Conv1d(in_channels if i == 0 else hidden, hidden,
                                                   5, stride=2))
        self.out = nn.Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        temb = self.t_embedder(t)
        h = x
        for i in range(self.depth):
            h = getattr(self, f"conv_{i}")(F.pad(h, same_pad(h.shape[-1], 5, 2)))
            h = F.silu(h + temb[:, :, None])
        return self.out(h.mean(dim=2))


def classifier_guided_eps(eps: torch.Tensor, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                          classifier: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                          schedule: DiffusionSchedule, scale: float = 1.0) -> torch.Tensor:
    """eps' = eps - s sqrt(1 - ac_t) grad_x log p(y | x_t) (ADM guidance); the
    gradient is taken under ``enable_grad``, since samplers run without."""
    with torch.enable_grad():
        x_in = x.detach().requires_grad_(True)
        logp = F.log_softmax(classifier(x_in, t), dim=-1)
        grad, = torch.autograd.grad(logp.gather(1, y.long()[:, None]).sum(), x_in)
    s1m = torch.from_numpy(schedule.sqrt_one_minus_alphas_cumprod).to(x.device)[t.long()]
    return eps - scale * s1m.reshape(-1, *([1] * (x.ndim - 1))) * grad


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """The source frames of ``jax.image.resize(method="nearest")`` (half-pixel
    centres): floor((i + 0.5) * (n_in * (1 / n_out))) in float32, the order
    in which XLA computes it. ``F.interpolate(mode="nearest")`` takes
    floor(i * n_in / n_out) instead."""
    f32 = np.float32
    scale = f32(n_in) * (f32(1) / f32(n_out))
    return np.floor((np.arange(n_out, dtype=f32) + f32(0.5)) * scale).astype(np.int64)


class LatentDiffusionInpaint(LatentDiffusion):
    """Trainable masked-latent inpainting LDM (``ddpm_audio_inpaint.py``):
    ``c_concat`` is the encoded masked mel with the latent-resized mask,
    ``c_crossattn`` the learned text conditioning; the backbone sees
    ``cat([x_noisy, c_concat], channel)`` with context ``c_crossattn``; the
    loss is the classic DDPM one with the VLB weight."""

    def __init__(self, *args, parameterization: str = "eps", original_elbo_weight: float = 0.0,
                 test_repeat: int = 1, test_numsteps: Optional[int] = None, **kwargs):
        kwargs.setdefault("conditioning_key", "hybrid")
        super().__init__(*args, **kwargs)
        self.parameterization = parameterization
        self.original_elbo_weight = original_elbo_weight
        self.test_repeat = test_repeat  # accepted and unused, as in the reference
        self.test_numsteps = test_numsteps or self.num_timesteps

    @staticmethod
    def resize_mask(mask: torch.Tensor, t_latent: int) -> torch.Tensor:
        """[B, 1, T_mel] -> [B, 1, t_latent], nearest as JAX resizes."""
        idx = torch.from_numpy(nearest_indices(mask.shape[-1], t_latent)).to(mask.device)
        return mask.index_select(-1, idx)

    def get_input(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                  noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """batch {'image', 'masked_image', 'mask', cond_stage_key} ->
        (z, {'c_concat', 'c_crossattn'}); posterior samples from
        ``generator`` or ``noise`` (a pair), the modes otherwise."""
        n1, n2 = noise if noise is not None else (None, None)
        z = self.encode_first_stage(batch[self.first_stage_key], generator, noise=n1)
        zm = self.encode_first_stage(batch["masked_image"], generator, noise=n2)
        mask = self.resize_mask(torch.as_tensor(batch["mask"], device=zm.device), zm.shape[-1])
        c_concat = torch.cat([zm, mask.to(zm.dtype)], dim=1)
        c_crossattn = self.get_learned_conditioning(batch[self.cond_stage_key])
        return z, {"c_concat": c_concat, "c_crossattn": c_crossattn}

    def apply_model(self, x_noisy: torch.Tensor, t: torch.Tensor, cond: Dict[str, Any],
                    step: int = 0, train: bool = False, **kw):
        xc = torch.cat([x_noisy, cond["c_concat"]], dim=1)
        return self.model(xc, t, cond["c_crossattn"], step=step, train=train)

    def _sampler_model(self) -> Model:
        return lambda x, t, context: self.apply_model(x, t, context)

    def p_losses(self, x_start: torch.Tensor, cond: Dict[str, Any], t: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                dtype=x_start.dtype)
        return ddpm_p_losses(self._sampler_model(), self.schedule, x_start, t, cond, noise,
                             parameterization=self.parameterization,
                             l_simple_weight=self.l_simple_weight,
                             original_elbo_weight=self.original_elbo_weight)

    def training_losses(self, x_start: torch.Tensor, cond: Dict[str, Any],
                        generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, dict]:
        """t ~ randint(0, T) (``ddpm_audio_inpaint.py:546-559``)."""
        t = torch.randint(0, self.num_timesteps, (x_start.shape[0],), generator=generator,
                          device=x_start.device)
        return self.p_losses(x_start, cond, t, generator)

    def sample_inpaint(self, cond: Dict[str, Any], generator: Optional[torch.Generator] = None,
                       shape: Optional[Tuple[int, ...]] = None, ddim_steps: Optional[int] = None,
                       eta: float = 0.0, x_T: Optional[torch.Tensor] = None,
                       noise: Optional[StepNoise] = None) -> torch.Tensor:
        """DDIM from the trained hybrid model over ``ddim_steps`` (default
        ``test_numsteps``), the mask and masked latent riding in ``c_concat``."""
        if shape is None:
            cc = cond["c_concat"]
            shape = (cc.shape[0], self.mel_dim, cc.shape[-1])
        sampler = DDIMSampler(self._sampler_model(), self.schedule)
        return sampler.sample(shape, cond, generator, S=ddim_steps or self.test_numsteps,
                              eta=eta, x_T=x_T, noise=noise, device=cond["c_concat"].device)


class AudioLDM(LatentDiffusion):
    """Text-to-audio LDM with AudioLDM's best-of-N generation
    (``audioldm.py:634-722``): ``n_candidates`` latents per caption, DDIM or
    PLMS with CFG, the outlier clip, decode, vocode, CLAP similarity, and per
    caption the candidate ``i + argmax(sims[i::B, i]) * B``."""

    def generate_batch(self, cond, captions: Sequence[str], vocoder_fn: Callable, clap,
                       generator: Optional[torch.Generator] = None, *, uncond=None,
                       guidance_scale: float = 1.0, n_candidates: int = 3,
                       ddim_steps: int = 200, eta: float = 1.0, use_plms: bool = False,
                       shape: Optional[Tuple[int, ...]] = None,
                       x_T: Optional[torch.Tensor] = None, noise: Optional[StepNoise] = None,
                       trace: Optional[Dict[str, Any]] = None) -> np.ndarray:
        """The best waveform per caption, ``[B, n_samples]``.

        ``cond``/``uncond``: the backbone's context trees for one copy of the
        batch, tiled ``n_candidates`` times here (candidate j of caption i is
        row ``i + j * B``). ``vocoder_fn``: mel [N, 80, T] -> waveforms [N, n]
        (an array or a tensor); ``clap``: ``get_audio_embeddings``,
        ``get_text_embeddings`` and ``compute_similarity``. ``trace``, when
        given, receives the latents, the waveforms, the similarities and the
        chosen rows."""
        B = len(captions)

        def tile(c):
            if isinstance(c, dict):
                return {k: tile(v) for k, v in c.items()}
            return torch.cat([c] * n_candidates, dim=0)

        ctx = tile(cond)
        uctx = tile(uncond) if uncond is not None else None
        if shape is None:
            shape = (B, self.mel_dim, self.mel_length)
        full_shape = (B * n_candidates,) + tuple(shape[1:])
        model = lambda x, t, c: self.model(x, t, c)
        kw = dict(S=ddim_steps, unconditional_guidance_scale=guidance_scale,
                  unconditional_conditioning=uctx, x_T=x_T, device=self.device)
        if use_plms:
            samples = PLMSSampler(model, self.schedule).sample(full_shape, ctx, generator, **kw)
        else:
            samples = DDIMSampler(model, self.schedule).sample(full_shape, ctx, generator,
                                                              eta=eta, noise=noise, **kw)
        # audioldm.py:699-701: clip runaway latents, decided over the whole batch
        samples = torch.where(samples.abs().amax() > 1e2, samples.clamp(-10.0, 10.0), samples)
        mel = self.decode_first_stage(samples.to(self.dtype))
        waveform = vocoder_fn(mel)
        if trace is not None:
            trace.update(samples=samples, waveform=waveform)
        if n_candidates <= 1:
            return _numpy(waveform)
        a_emb = clap.get_audio_embeddings(waveform)
        t_emb = clap.get_text_embeddings(list(captions))
        sims = _numpy(clap.compute_similarity(a_emb, t_emb))  # [B*n, B]
        best_index = [i + int(np.argmax(sims[i::B, i])) * B for i in range(B)]
        if trace is not None:
            trace.update(audio_emb=a_emb, text_emb=t_emb, sims=sims, best_index=best_index)
        return _numpy(waveform)[best_index]


class LatentDiffusionOrder(LatentDiffusion):
    """``ddpm_audio_order.LatentDiffusion_audio``: single-key conditioning
    dispatch, the cond handed to the backbone whole (``{'c_concat': cond}``
    in concat mode, ``cond`` itself otherwise, the inner ``c_crossattn`` of
    a wrapped one)."""

    def apply_model(self, x_noisy: torch.Tensor, t: torch.Tensor, cond, step: int = 0,
                    train: bool = False, **kw):
        if isinstance(cond, dict) and ("c_concat" in cond or "c_crossattn" in cond):
            context = cond.get("c_crossattn", cond)
        elif self.conditioning_key == "concat":
            context = {"c_concat": cond}
        else:
            context = cond
        return self.model(x_noisy, t, context, step=step, train=train)
