#!/usr/bin/env python3
"""Device time per served clip for this tree and another, in alternated pairs.

Each run is a fresh process started in one tree's root that builds its
kernels, then runs that tree's ``chip_smoke.phase_serve`` alone (3 pipelined
20 s requests at the shipped widths, bf16) and prints the per-clip medians
of the sampler and of the whole clip (CUDA events). Pairs alternate which
tree runs first. The sampler is host-bound, so its event time follows the
host's speed; pairs in one call are the comparison that holds.

Run from the repository root on a machine with a GPU:
    python3 serving_pairs.py OTHER_ROOT [--pairs 10]
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
from pathlib import Path

SERVE = ("import torch, chip_smoke as cs; cs.phase_card(); cs.phase_build(); "
         "cs.phase_serve(torch.device('cuda'))")
PER_CLIP = re.compile(r"\[serve\] per clip .*?sample ([\d.]+) ms.*?total ([\d.]+) ms; rtf ([\d.]+)x")


def serve_once(root: Path) -> tuple:
    out = subprocess.run([sys.executable, "-c", SERVE], cwd=root, capture_output=True,
                         text=True, timeout=600)
    m = PER_CLIP.search(out.stdout)
    if out.returncode != 0 or m is None:
        raise RuntimeError(f"serving in {root} failed ({out.returncode}):\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    return float(m[1]), float(m[2]), float(m[3])


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], q[2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other tree (e.g. the parent, unpacked)")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    roots = {"this tree": Path.cwd(), "other": Path(args.other).resolve()}
    runs = {name: [] for name in roots}
    for i in range(args.pairs):
        order = list(roots) if i % 2 == 0 else list(roots)[::-1]
        for name in order:
            sample, total, rtf = serve_once(roots[name])
            runs[name].append(total)
            print(f"[pairs] pair {i + 1} {name}: sampler {sample:.2f} ms, clip {total:.2f} ms, "
                  f"rtf {rtf:.2f}x", flush=True)
    wins = sum(a < b for a, b in zip(runs["this tree"], runs["other"]))
    for name, xs in runs.items():
        lo, hi = quartiles(xs)
        print(f"[pairs] {name}: clip ms median {statistics.median(xs):.2f}, quartiles "
              f"{lo:.2f}-{hi:.2f}, min {min(xs):.2f}, max {max(xs):.2f}")
    print(f"[pairs] this tree faster in {wins} of {args.pairs} pairs")


if __name__ == "__main__":
    main()
