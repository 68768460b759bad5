#!/usr/bin/env python3
"""Host time per ``flash_attention`` call as the sampler makes it, for this
tree and, optionally, for another tree's ``flash_attention.py``.

The sampler is host-bound, so what a call costs on the host's clock is what
it adds to a clip. At the serving shape (q/k/v ``[2, 752, 8, 96]`` bf16, no
``kv_len``) under ``torch.inference_mode``, each sample times ``--calls``
calls with no synchronize among them (the card's queue takes the kernels;
the host never waits), then synchronizes. Samples alternate A, B, B, A, so a
drift in the host's speed falls on both. The other file is loaded as a
module of its own beside this package and launches the same K1 library.
Prints microseconds per call for every sample and the median of each side.

Run from the repository root on a machine with a GPU:
    python3 attn_host_cost.py [--other DIR/versband_tpu_torch/ops/flash_attention.py]
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import subprocess
import time

import torch

from versband_tpu_torch.ops import flash_attention as fa


def load_other(path: str):
    spec = importlib.util.spec_from_file_location("other_flash_attention", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(flash, q, k, v, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        flash(q, k, v)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another tree's versband_tpu_torch/ops/flash_attention.py")
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=10, help="A, B, B, A groups")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_host_cost: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    sides = {"this tree": fa.flash_attention}
    if args.other:
        sides["other"] = load_other(args.other).flash_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 752, 8, 96, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    names = list(sides)
    order = (names + names[::-1]) * args.rounds
    samples = {n: [] for n in names}
    with torch.inference_mode():
        for n in names:  # build, load and warm up
            host_us(sides[n], q, k, v, 20)
        for n in order:
            samples[n].append(host_us(sides[n], q, k, v, args.calls))
    for n in names:
        print(f"[attn host] {n}: host us per flash_attention call, {len(samples[n])} samples of "
              f"{args.calls} calls: median {statistics.median(samples[n]):.2f}, min "
              f"{min(samples[n]):.2f}, max {max(samples[n]):.2f}; "
              + " ".join(f"{x:.2f}" for x in samples[n]))


if __name__ == "__main__":
    main()
