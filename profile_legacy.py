#!/usr/bin/env python3
"""Where a step of the legacy backbones' samplers goes on one NVIDIA GPU.

Builds ``chip_smoke.py``'s ``TimeFreqMoeDiT`` (``VideoFlagLargeDiT`` at its
published widths) and ``ConcatOrderDiT`` (its class defaults) on the card in
fp32 (TF32 off), their zero-init weights drawn, and runs one sampler step of
each at the shapes ``[timefreq-cli]`` and ``[concat-order]`` give it: a CFG
Euler step at B 2 x T 752 with an 80-token caption, and a DDIM step at B 2
over 1 + 64 + 752 tokens. Each step runs once warm, once timed by
``utils/profiling.py::StepTimer`` and once under ``utils/profiling.py::trace``
(a Chrome trace under ``build/profile_legacy/``). Prints per model the
wall ms, device-busy ms (union of kernel intervals), the idle share, the
kernels' time by kind (matrix products, convolutions, softmax, elementwise
and the rest) and the kernels that take the most device time, then
``device_memory_stats``. First it times ``TimeFreqMoeDiT``'s construction
(its weights' init) on the host and the copy to the card, against building it
on the card, as ``models/cfm.py::LatentDiffusion._build`` does.

Run from the repository root:  python3 profile_legacy.py
"""

from __future__ import annotations

import collections
import re
import time

import torch
from torch.autograd import DeviceType

import chip_smoke as cs
from profile_serving import busy_ms
from versband_tpu_torch.utils import profiling

TOP = 8
KINDS = (("products", r"gemm|sgemm|cutlass|xmma|matmul"), ("convolutions", r"conv|implicit|winograd|fft|cudnn"),
         ("softmax", r"softmax"), ("elementwise", r"elementwise|vectorized|unrolled|reduce|norm"))


def kind(name: str) -> str:
    low = name.lower()
    return next((k for k, rx in KINDS if re.search(rx, low)), "other")


def profile_step(tag: str, step) -> None:
    step()
    torch.cuda.synchronize()
    timer = profiling.StepTimer()
    timer.start()
    out = step()
    wall = timer.stop(out) * 1e3
    with profiling.trace(f"build/profile_legacy/{tag}") as prof:
        with profiling.annotate(tag):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name != tag]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device kernels")
    busy = busy_ms(kernels)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    by_kind = collections.defaultdict(float)
    for k in kernels:
        ms = (k.time_range.end - k.time_range.start) / 1e3
        by_name[k.name][0] += 1
        by_name[k.name][1] += ms
        by_kind[kind(k.name)] += ms
    print(f"[{tag}] wall {wall:.2f} ms, device busy {busy:.2f} ms, idle {1 - busy / wall:.1%}, "
          f"{len(kernels)} kernels; by kind: " + ", ".join(
              f"{n} {t:.2f} ms ({t / busy:.1%})" for n, t in sorted(by_kind.items(),
                                                                   key=lambda kv: -kv[1])))
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]:
        print(f"[{tag}]   {ms:9.2f} ms {n:5d} x  {name[:110]}")


@torch.no_grad()
def main() -> None:
    from versband_tpu_torch.models.concat_dit import ConcatOrderDiT
    from versband_tpu_torch.models.dit_timefreq import TimeFreqMoeDiT

    smi = cs.phase_card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    t0 = time.perf_counter()
    model = TimeFreqMoeDiT(**cs.TIMEFREQ)
    t1 = time.perf_counter()
    model.to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del model
    cs.free_card()
    t3 = time.perf_counter()
    with torch.device(dev):
        model = TimeFreqMoeDiT(**cs.TIMEFREQ).eval()
    torch.cuda.synchronize()
    print(f"[build] TimeFreqMoeDiT ({sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
          f"parameters): on the host {t1 - t0:.2f} s and .to(cuda) {t2 - t1:.2f} s, against "
          f"{time.perf_counter() - t3:.2f} s made on the card")
    cs.perturb_zeros(model, cs.SEED)
    x = torch.randn(2, 20, cs.T_LAT, generator=g, device=dev)
    t = torch.full((2,), 500.0, device=dev)
    cap = torch.randn(2, 80, cs.TIMEFREQ["context_dim"], generator=g, device=dev)
    profile_step("timefreq euler step", lambda: model(x, t, {"c_crossattn": cap})[0])
    del model
    cs.free_card()
    with torch.device(dev):
        model = ConcatOrderDiT(**cs.CONCAT_ORDER).eval()
    cs.perturb_zeros(model, cs.SEED)
    ids = torch.full((2, cs.ORDER_TC), 0, dtype=torch.long, device=dev)
    ids[:, :8] = torch.tensor([101, 2000, 1064, 2001, 1064, 2002, 102, 0])
    ctx = {"token_embedding": torch.randn(2, cs.ORDER_TC, cs.CONCAT_ORDER["context_dim"],
                                          generator=g, device=dev),
           "token_ids": ids, "orders": torch.tensor([[3, 1, 4] + [100] * 7] * 2, device=dev)}
    profile_step("concat-order ddim step", lambda: model(x, t, ctx)[0])
    stats = profiling.device_memory_stats(dev)
    print(f"device_memory_stats: bytes_in_use {stats['bytes_in_use']:.0f} MiB, "
          f"peak_bytes_in_use {stats['peak_bytes_in_use']:.0f} MiB ({len(stats)} keys)")
    print(smi)


if __name__ == "__main__":
    main()
