#!/usr/bin/env python3
"""What the port's op-by-op bf16 rounding costs the served sampler and decode, on one NVIDIA GPU.

``versband_tpu_torch/nn/rounding.py`` makes the bf16 DiT and VAE round where
the JAX package rounds op by op: a bias is added to the rounded product in a
second pass, and SiLU, GELU and softmax are composed from rounded steps. This
script times, in one process and in alternation, the shipped-width bf16 CFG
sampler (``chip_smoke.STEPS`` Euler steps, encode once) and the VAE decode of
one 20 s clip on ``chip_smoke.bf16_serve_inputs()``, with those pieces as
shipped ("op by op") and switched to torch's fused ops ("fused"; the float32
norms, expert products and routing stay in both). It prints the median and
quartiles of the CUDA-event times, the CUDA kernels each launches and their
summed device time (``torch.profiler``), the two variants' relative L2
distance, whether a bf16 ``nn.Conv1d`` on the card already adds its bias to
the rounded product (as the op-by-op ``Conv1d`` does), and the card's name
and power limit.

Run from the repository root on a machine with a GPU:
    python3 bf16_rounding_cost.py [--reps 10]
"""

from __future__ import annotations

import argparse
import contextlib
import statistics

import torch
import torch.nn as nn
import torch.nn.functional as F

import chip_smoke as cs
from versband_tpu_torch.models import autoencoder, dit
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.nn import core, rounding

# the rounding pieces, wherever a module took them by name, and torch's fused op for each
FUSED = [(rounding, "sigmoid", torch.sigmoid), (rounding, "silu", F.silu),
         (rounding, "gelu", F.gelu), (rounding, "softmax", torch.softmax),
         (rounding, "linear", F.linear), (core, "silu", F.silu), (dit, "linear", F.linear),
         (dit, "softmax", torch.softmax), (autoencoder, "silu", F.silu),
         (rounding.Conv1d, "forward", nn.Conv1d.forward)]


@contextlib.contextmanager
def fused():
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in FUSED]
    for obj, name, fn in FUSED:
        setattr(obj, name, fn)
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def event_ms(fn) -> tuple:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def kernels(fn) -> tuple:
    """(CUDA kernels ``fn`` launches, their summed device time in ms); -1
    and nan where the profiler sees none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return (len(events), busy) if events else (-1, float("nan"))


def conv_bias_rounds_twice(dev) -> bool:
    """Whether the card's bf16 ``nn.Conv1d`` (cuDNN) equals its product
    rounded to bf16 plus the bias, rounded again, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    conv = nn.Conv1d(256, 256, 7, padding=3).to(dev, torch.bfloat16)
    x = torch.randn(1, 256, 4096, generator=g, device=dev).to(torch.bfloat16)
    return torch.equal(conv(x), F.conv1d(x, conv.weight, None, padding=3) + conv.bias[:, None])


def summary(xs) -> str:
    q = statistics.quantiles(xs, n=4)
    return f"median {statistics.median(xs):.2f} ms (quartiles {q[0]:.2f}-{q[2]:.2f})"


@torch.inference_mode()
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    smi = cs.phase_card()
    cs.phase_build()
    dev = torch.device("cuda")
    w = cs.bf16_serve_inputs()
    cfm = CFM(unet_config=dict(target="versband_tpu.models.dit.BandMoeDiT", params=cs.DIT),
              first_stage_config=dict(target="versband_tpu.models.autoencoder.AutoencoderKL",
                                      params=cs.VAE),
              mel_dim=20, scale_factor=1.0, device=dev, dtype=cs.DTYPE)
    cfm.model.load_state_dict(w["dit"].state_dict())
    cfm.first_stage.load_state_dict(w["vae"].state_dict())
    tree = {k: {"caption": c["caption"].to(dev),
                "acoustic": {a: v.to(dev) for a, v in c["acoustic"].items()}}
            for k, c in (("cond", w["cond"]), ("uncond", w["uncond"]))}
    z0 = w["z0"].to(dev)

    def sample():
        return cfm.sample_cfg(tree["cond"], cs.CFG_SCALE, tree["uncond"], x_latent=z0,
                              timesteps=cs.STEPS)

    variants = {"op by op": contextlib.nullcontext, "fused": fused}
    times = {v: {"sampler": [], "decode": []} for v in variants}
    outs, counts = {}, {}
    for v, ctx in variants.items():  # warm-up, outputs and kernel counts
        with ctx():
            z = sample()
            outs[v] = (z, cfm.decode_first_stage(z))
            counts[v] = (kernels(sample), kernels(lambda: cfm.decode_first_stage(z)))
    for i in range(args.reps):
        for v in (list(variants) if i % 2 == 0 else list(variants)[::-1]):
            with variants[v]():
                ms, z = event_ms(sample)
                times[v]["sampler"].append(ms)
                times[v]["decode"].append(event_ms(lambda: cfm.decode_first_stage(z))[0])
    print(f"[rounding-cost] {smi}; {args.reps} alternated reps, bf16, T_lat {cs.T_LAT}, "
          f"{cs.STEPS} steps, CFG {cs.CFG_SCALE}")
    for v in variants:
        (n_s, busy_s), (n_d, busy_d) = counts[v]
        print(f"[rounding-cost] {v}: sampler {summary(times[v]['sampler'])}, {n_s} kernels "
              f"busy {busy_s:.2f} ms; decode {summary(times[v]['decode'])}, {n_d} kernels "
              f"busy {busy_d:.2f} ms")
    for stage in ("sampler", "decode"):
        pairs = [a / b for a, b in zip(times["op by op"][stage], times["fused"][stage])]
        print(f"[rounding-cost] {stage}: op by op / fused per rep, median "
              f"{statistics.median(pairs):.4f}, range {min(pairs):.4f}-{max(pairs):.4f}")
    for i, stage in enumerate(("latent", "mel")):
        a, b = outs["op by op"][i].double(), outs["fused"][i].double()
        finite = bool(torch.isfinite(a).all() and torch.isfinite(b).all())
        print(f"[rounding-cost] {stage}: op by op against fused relative L2 "
              f"{float((a - b).norm() / b.norm()):.4e}, finite {finite}")
    print(f"[rounding-cost] bf16 nn.Conv1d on the card adds its bias to the rounded product: "
          f"{conv_bias_rounds_twice(dev)}")


if __name__ == "__main__":
    main()
