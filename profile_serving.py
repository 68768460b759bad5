#!/usr/bin/env python3
"""Where the serving path's time goes on one NVIDIA GPU.

Builds the shipped-width bf16 serving models of ``chip_smoke.py`` (random
weights from its seed), serves one warm-up clip, then runs each stage of one
20 s clip (sampler, VAE decode, HiFi-GAN) twice: once plain, timed on the
host clock up to a synchronize, and once under ``torch.profiler``. Prints,
per stage: wall ms, device-busy ms (union of kernel intervals), the idle
share of the card, the kernel count, K1's time and launches, and the kernels
that take the most device time.

Run from the repository root:  python3 profile_serving.py
"""

from __future__ import annotations

import collections
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs

TOP = 12


def busy_ms(kernels) -> float:
    """Length of the union of the kernels' [start, end) intervals, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def run_stage(name: str, fn) -> object:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device kernels")
    busy = busy_ms(kernels)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for k in kernels:
        by_name[k.name][0] += 1
        by_name[k.name][1] += (k.time_range.end - k.time_range.start) / 1e3
    k1 = sum(t for n, (_, t) in by_name.items() if "flash_fwd" in n)
    k1_n = sum(c for n, (c, _) in by_name.items() if "flash_fwd" in n)
    print(f"[{name}] wall {wall:.2f} ms, device busy {busy:.2f} ms, idle {1 - busy / wall:.1%}, "
          f"{len(kernels)} kernels, K1 {k1:.3f} ms in {k1_n} launches "
          f"({k1 / busy:.1%} of busy)")
    for n, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]:
        print(f"[{name}]   {t:8.3f} ms {c:6d}x  {n[:110]}")
    return out


def main() -> None:
    cs.phase_card()
    dev = torch.device("cuda")
    cfm, voc, uncond, requests = cs.build_serving(dev, n_requests=2)
    with torch.inference_mode():
        warm, _ = requests[0]
        voc.model(cfm.decode_first_stage(cfm.sample_cfg(warm, cs.CFG_SCALE, uncond,
                                                         timesteps=cs.STEPS)))
        cond, gen = requests[1]
        z = run_stage("sample", lambda: cfm.sample_cfg(cond, cs.CFG_SCALE, uncond, gen,
                                                       timesteps=cs.STEPS))
        mel = run_stage("decode", lambda: cfm.decode_first_stage(z))
        run_stage("vocode", lambda: voc.model(mel))


if __name__ == "__main__":
    main()
