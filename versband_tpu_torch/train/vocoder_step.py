"""The vocoders' GAN training steps (port of ``versband_tpu/train/vocoder_step.py``).

* HiFi-GAN / BigVGAN: MPD with MSD (or MRD), LSGAN adversarial,
  feature-matching and mel-L1 losses (``vocoder/hifigan/modules/hifigan.py:344-382``);
  the discriminator is updated first, on the generator's detached output,
  then the generator against the updated discriminator.
* ParallelWaveGAN: multi-resolution STFT loss plus the adversarial term
  after ``disc_start`` (``parallel_wavegan/losses/stft_loss.py``); the
  generator is updated first, then the discriminator on the detached output,
  its loss multiplied by the same warm-up gate (before it, a zero gradient,
  and the optimizer still counts the step, as in JAX).

Each step updates the two ``TrainState``s in place and returns the JAX
step's metrics (detached tensors, no host sync). Gradients are taken with
``torch.autograd.grad`` with respect to one side's parameters only, so the
generator's loss leaves nothing in the discriminator's ``.grad``.

Vocoder training runs the unfused modules: neither K4 nor K5 has a
backward, and a generator that would launch one is refused with a
``ValueError``, as the JAX package refuses ``use_fused``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from versband_tpu_torch.train.state import TrainState
from versband_tpu_torch.vocoder.discriminators import (discriminator_loss, feature_loss,
                                                       generator_loss)
from versband_tpu_torch.vocoder.losses import multi_resolution_stft_loss


def _apply(state: TrainState, loss: torch.Tensor) -> None:
    """Set ``.grad`` of the state's parameters to d loss / d param and step."""
    grads = torch.autograd.grad(loss, state.params, allow_unused=True)
    for p, g in zip(state.params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    state.apply_gradients()


def make_hifigan_train_step(generator, mpd, msd, mel_fn: Callable,
                            lambda_fm: float = 2.0, lambda_mel: float = 45.0):
    """HiFi-GAN step. ``mel_fn(wav [B, T]) -> mel`` for the mel L1 term
    (``dsp.mel.MelSpectrogram``). ``msd`` is the second discriminator (MSD, or
    MRD for BigVGAN). ``batch`` = {'mel': [B, 80, T'], 'wav': [B, T]}.
    Returns ``step(gen_state, disc_state, batch) -> metrics``; ``disc_state``
    trains both discriminators' parameters."""
    if getattr(generator, "use_fused", False):
        raise ValueError(
            "this generator was built with use_fused=True: K4, the fused alias-free "
            "activation, has no backward; build the training generator with use_fused=False")

    def step(gen_state: TrainState, disc_state: TrainState,
             batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        mel, wav = batch["mel"], batch["wav"]
        y = wav[:, None, :]

        with torch.no_grad():
            y_hat = generator(mel)[:, None, :]
        rs, gs, _, _ = mpd(y, y_hat)
        r1, g1 = discriminator_loss(rs, gs)
        rs2, gs2, _, _ = msd(y, y_hat)
        r2, g2 = discriminator_loss(rs2, gs2)
        d = r1 + g1 + r2 + g2
        _apply(disc_state, d)

        wav_hat = generator(mel)
        y_g = wav_hat[:, None, :]
        with torch.no_grad():
            _, fr = mpd.single(y)
            _, fr2 = msd.single(y)
            mel_real = mel_fn(wav)
        gs, fg = mpd.single(y_g)
        gs2, fg2 = msd.single(y_g)
        adv = generator_loss(gs) + generator_loss(gs2)
        fm = feature_loss(fr, fg) + feature_loss(fr2, fg2)
        mel_l1 = torch.mean(torch.abs(mel_fn(wav_hat) - mel_real))
        total = adv + lambda_fm * fm + lambda_mel * mel_l1
        _apply(gen_state, total)
        return {"disc_loss": d.detach(), "gen_adv": adv.detach(), "fm_loss": fm.detach(),
                "mel_l1": mel_l1.detach(), "gen_loss": total.detach()}

    return step


def make_pwg_train_step(generator, discriminator, lambda_adv: float = 4.0,
                        disc_start: int = 100_000):
    """ParallelWaveGAN step: MR-STFT + the adversarial loss from
    ``disc_start`` generator steps on. ``batch`` = {'mel': [B, 80, T'+2w],
    'noise': [B, 1, T], 'wav': [B, T]}."""
    if getattr(generator, "fused_inference", False):
        raise ValueError(
            "this generator was built with fused_inference=True: K5, the fused WaveNet "
            "layer, has no backward; build the training generator with fused_inference=False")

    def step(gen_state: TrainState, disc_state: TrainState,
             batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        mel, noise, wav = batch["mel"], batch["noise"], batch["wav"]
        warm = float(gen_state.step >= disc_start)

        wav_hat = generator(noise, mel)[:, 0, :]
        sc, mag = multi_resolution_stft_loss(wav_hat, wav)
        # LSGAN generator term, mse(D(fake), 1), as in upstream parallel_wavegan
        adv = torch.mean((1.0 - discriminator(wav_hat[:, None, :])) ** 2)
        total = sc + mag + warm * lambda_adv * adv
        _apply(gen_state, total)

        wav_hat = wav_hat.detach()
        real = discriminator(wav[:, None, :])
        fake = discriminator(wav_hat[:, None, :])
        d = torch.mean((1.0 - real) ** 2) + torch.mean(fake ** 2)
        _apply(disc_state, warm * d)
        return {"sc_loss": sc.detach(), "mag_loss": mag.detach(), "gen_adv": adv.detach(),
                "gen_loss": total.detach(), "disc_loss": d.detach()}

    return step
