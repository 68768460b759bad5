#!/usr/bin/env python3
"""K1 (the flash-attention forward) in other block shapes, on one NVIDIA GPU.

The block shape of ``versband_tpu_torch/ops/csrc/flash_attn_fwd.cu`` is four
constants of its ``Cfg``: m-tiles per warp (``MT``), ``WARPS``, keys per
streamed tile (``BN``) and ring ``STAGES``, most with a bf16 and an fp32
value. This script writes a copy of the source per variant below into
``build/k1_variants/`` with some of them replaced, compiles the copies (all
nvcc runs started together), holds each against the plain version on the
serving shape and on a ragged, masked case, and times each at K1's serving
and training shapes in both types, in forward then reverse order, beside
``F.scaled_dot_product_attention`` and the bound. It then times the shipped
kernel at the serving shape with ``kv_len`` from 0 to 752 keys: the time at 0
keys is the launch's fixed cost, the slope the cost per key.

Run from the repository root on a machine with a GPU:  python3 k1_variants.py
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
import time

import torch
import torch.nn.functional as F

import chip_smoke as cs
from versband_tpu_torch.ops import _build
from versband_tpu_torch.ops import flash_attention as fa

# name -> {Cfg constant: the expression that replaces its value}
VARIANTS = {
    "shipped": {},
    "bf16 64 rows, 4 warps x 1 m-tile, 64-key tiles, 2 stages": {"MT": "1"},
    "bf16 128 rows, 4 warps x 2 m-tiles, 32-key tiles, 2 stages": {"BN": "32"},
    "bf16 128 rows, 4 warps x 2 m-tiles, 64-key tiles, 3 stages": {"STAGES": "BF16 ? 3 : 2"},
    "fp32 64 rows, 4 warps": {"WARPS": "4"},
}
CFG_LINE = re.compile(r"(static constexpr int (MT|WARPS|BN|STAGES) = )([^;]+);")
SHAPES = {"serving": (2, cs.T_LAT, 8, 96), "training": (cs.TRAIN_B, cs.T_TRAIN, 8, 96)}


def variant_source(src: str, changes: dict) -> str:
    out, n = CFG_LINE.subn(lambda m: f"{m[1]}{changes.get(m[2], m[3])};", src)
    if n != 4:
        raise RuntimeError(f"expected the 4 block-shape constants of Cfg, found {n}")
    return out


def build(out_dir) -> dict:
    """name -> K1 entry point of that variant's library."""
    nvcc, src = _build.find_nvcc(), (_build.CSRC / "flash_attn_fwd.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, changes) in enumerate(VARIANTS.items()):
        cu, lib = out_dir / f"k1_{i}.cu", out_dir / f"libk1_{i}.so"
        cu.write_text(variant_source(src, changes))
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs, entry, spill = [], "?", "?"
        for line in log.splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                entry = m[1]
            elif m := re.search(r"(\d+) bytes spill stores", line):
                spill = m[1]
            elif (m := re.search(r"Used (\d+) registers", line)) and "Li96E" in entry:
                regs.append(f"{'bf16' if 'bfloat' in entry else 'fp32'} {m[1]} registers, "
                            f"{spill} B spilled")
        print(f"[k1 variants] {name}: D = 96: {'; '.join(regs)}")
        fns[name] = fa.bind_fwd(ctypes.CDLL(str(lib.resolve())))
    return fns


def main() -> None:
    smi = cs.phase_card()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    fns = build(_build.BUILD_ROOT.parent / "k1_variants")
    print(f"[k1 variants] {len(fns)} variants built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def qkv(B, Tq, Tk, H, D, dtype):
        return [torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype)
                for T in (Tq, Tk, Tk)]

    points = {(name, dtype): qkv(B, T, T, H, D, dtype) for name, (B, T, H, D) in SHAPES.items()
              for dtype in (torch.bfloat16, torch.float32)}
    ragged = {dtype: qkv(3, 100, 203, 8, 96, dtype) for dtype in (torch.bfloat16, torch.float32)}
    kv_len = torch.tensor([203, 0, 77], dtype=torch.int32, device=dev)
    for name, fn in fns.items():  # every variant computes K1's function
        fa._FN = fn
        for dtype in (torch.bfloat16, torch.float32):
            for args, lens, scale in ((points[("serving", dtype)], None, 1 / math.sqrt(96)),
                                      (ragged[dtype], kv_len, 0.3)):
                out, lse = fa.flash_attention_fwd(*args, lens, scale)
                ref, ref_lse = fa._reference_fwd(*args, lens, scale)
                err = (out.float() - ref.float()).abs().max().item()
                if not err <= cs.K1_TOL[dtype] or (lens is not None and (out[1] != 0).any()):
                    raise AssertionError(f"variant {name} disagrees with the plain version: "
                                         f"{err}")
    times = {}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            fa._FN = fns[name]
            for key, (q, k, v) in points.items():
                times.setdefault((name, key), []).append(
                    cs.cuda_ms(lambda: fa.flash_attention(q, k, v), 50))
    for (shape, dtype), (q, k, v) in points.items():
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = cs.cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 50)
        bound, by = cs.k1_bound_ms(q, k, v, None)
        dt = str(dtype).replace("torch.", "")
        print(f"[k1 variants] {shape} {dt} q{tuple(q.shape)}: scaled_dot_product_attention "
              f"{lib:.4f} ms, bound {bound:.4f} ms ({by})")
        for name in fns:
            t = times[(name, (shape, dtype))]
            print(f"[k1 variants]   {t[0]:.4f} / {t[1]:.4f} ms ({bound / min(t):.1%} of bound)"
                  f"  {name}")
    fa._FN = fns["shipped"]
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = points[("serving", dtype)]
        row = []
        for n in (0, 64, 128, 256, 384, 512, 752):
            lens = torch.full((q.shape[0],), n, dtype=torch.int32, device=dev)
            row.append(f"{n}: {cs.cuda_ms(lambda: fa.flash_attention(q, k, v, lens), 50):.4f}")
        print(f"[k1 variants] shipped, serving {str(dtype)[6:]}, ms by kv_len: " + ", ".join(row))
    print(smi)


if __name__ == "__main__":
    main()
