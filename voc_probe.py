#!/usr/bin/env python3
"""Where the vocoder slice's time and rounding go, on one NVIDIA GPU.

    python3 voc_probe.py nsf     # HiFi-GAN NSF at 20 s: the whole, its parts
    python3 voc_probe.py grad    # one HiFi-GAN-recipe step's gradients

``nsf``: device time (``chip_smoke.cuda_ms``) of ``NSFHifiGanGenerator()``
on a 1504-frame mel with f0, of the HiFi-GAN stack alone, of the harmonic
source, of the noise convs, and of the source's running sum laid out as
``sine_gen`` takes it (one scan along T of ``[B, T]``) against a scan along
T of the ``[B, T, 9]`` harmonics.

``grad``: one full-width HiFi-GAN-recipe step (``chip_smoke``'s
``[voc-step]`` weights and batch) on the card in fp32 through cuDNN
(default, deterministic and benchmarked algorithms) and through PyTorch's
own CUDA convolutions (cuDNN off), each against the same step in float64 on
the CPU: the worst gradients as max|d| over max(max|grad|, 1e-3 x the
largest gradient), and the generator's forward alone.
"""

from __future__ import annotations

import copy
import sys

import torch

import chip_smoke as cs


def probe_nsf(dev) -> None:
    from versband_tpu_torch.vocoder.nsf import NSFHifiGanGenerator, estimate_f0_from_mel

    torch.manual_seed(cs.SEED)
    model = NSFHifiGanGenerator().to(dev).eval()
    mel = torch.randn(1, 80, cs.T_MEL, device=dev) - 2.0
    f0 = torch.from_numpy(estimate_f0_from_mel(mel[0].cpu().numpy()))[None].to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        f0_up = torch.repeat_interleave(f0[:, :, None], model.hop, dim=1)
        har = model.m_source(f0_up, g).transpose(1, 2).contiguous()
        rad = (f0_up.double() * torch.arange(1, 10, device=dev, dtype=torch.float64) / cs.SR)
        parts = {
            "whole (mel, f0)": lambda: model(mel, f0, generator=g),
            "HiFi-GAN stack alone (no f0)": lambda: model(mel),
            "harmonic source (m_source)": lambda: model.m_source(f0_up, g),
            "noise convs (4)": lambda: [c(har) for c in model.noise_convs],
            "float64 scan along T of [1, T] (sine_gen)":
                lambda: torch.cumsum(f0_up[..., 0].double(), dim=1),
            "float64 scan along T of [1, T, 9]": lambda: torch.cumsum(rad, dim=1),
        }
        for name, fn in parts.items():
            print(f"[voc-probe] nsf {name}: {cs.cuda_ms(fn, 5):.3f} ms")


def probe_grad(dev) -> None:
    from versband_tpu_torch.dsp.mel import MelSpectrogram
    from versband_tpu_torch.train.state import TrainState, make_adamw
    from versband_tpu_torch.train.vocoder_step import make_hifigan_train_step
    from versband_tpu_torch.vocoder.conv import apply_weight_norm
    from versband_tpu_torch.vocoder.discriminators import (MultiPeriodDiscriminator,
                                                          MultiScaleDiscriminator)
    from versband_tpu_torch.vocoder.hifigan import HifiGanGenerator

    torch.manual_seed(cs.SEED + 70)  # [voc-step]'s weights and batch
    plain = HifiGanGenerator()
    plain.load_state_dict(cs.scaled_conv_weights(plain, cs.SEED + 70))
    gen0 = apply_weight_norm(plain)
    disc0 = torch.nn.ModuleDict({"mpd": MultiPeriodDiscriminator(),
                                 "msd": MultiScaleDiscriminator()})
    wav = cs.voc_audio(torch.device("cpu"), 1, cs.VOC_SEG + 2 * cs.PWG_CTX * cs.HOP, cs.SEED + 71)
    seg = wav[:, cs.PWG_CTX * cs.HOP: cs.PWG_CTX * cs.HOP + cs.VOC_SEG].contiguous()
    mel_fn = MelSpectrogram()
    mel = mel_fn(seg)

    def run(device, dtype, **flags):
        gen, disc = copy.deepcopy(gen0).to(device, dtype), copy.deepcopy(disc0).to(device, dtype)
        gs = TrainState(gen, make_adamw(**cs.HIFIGAN_OPT))
        ds = TrainState(disc, make_adamw(**cs.HIFIGAN_OPT))
        step = make_hifigan_train_step(gen, disc["mpd"], disc["msd"], mel_fn)
        with torch.backends.cudnn.flags(allow_tf32=False, **flags):
            return cs._voc_step_grads(step, gs, ds, {"mel": mel.to(device, dtype),
                                                     "wav": seg.to(device, dtype)})

    with torch.no_grad():
        y64 = copy.deepcopy(gen0).double()(mel.double())
        y32 = copy.deepcopy(gen0).to(dev)(mel.to(dev))
    print(f"[voc-probe] grad generator forward, card fp32 vs CPU float64: max|d| "
          f"{(y32.double().cpu() - y64).abs().max().item():.3e} of max|y| "
          f"{y64.abs().max().item():.3f}")
    m_ref, ref = run(torch.device("cpu"), torch.float64)
    big = max(g.abs().max().item() for g in ref.values())
    for label, flags in (("cuDNN default", dict(enabled=True)),
                         ("cuDNN deterministic", dict(enabled=True, deterministic=True)),
                         ("cuDNN benchmark", dict(enabled=True, benchmark=True)),
                         ("cuDNN off", dict(enabled=False))):
        m, g = run(dev, torch.float32, **flags)
        rel = {k: (g[k] - r).abs().max().item() / max(r.abs().max().item(), 1e-3 * big)
               for k, r in ref.items()}
        worst = sorted(rel, key=rel.get)[-3:]
        lerr = max(abs(m[k] - m_ref[k]) / abs(m_ref[k]) for k in m_ref)
        print(f"[voc-probe] grad card fp32, {label}, vs CPU float64: losses {lerr:.2e} "
              f"relative; worst gradients " + ", ".join(f"{k} {rel[k]:.2e}" for k in worst))


def main() -> None:
    what = sys.argv[1:] or ["nsf", "grad"]
    cs.phase_card()
    torch.set_num_threads(8)
    dev = torch.device("cuda")
    for name in what:
        {"nsf": probe_nsf, "grad": probe_grad}[name](dev)


if __name__ == "__main__":
    main()
