#!/usr/bin/env python3
"""K1, K4 or K5 in other forms, on one NVIDIA GPU.

Writes a copy of the kernel's source (``versband_tpu_torch/ops/csrc/``
``flash_attn_fwd.cu`` for K1, ``fused_act1d.cu`` for K4, ``fused_wavenet.cu``
for K5) per variant below into ``build/kernel_variants/`` with some of its
lines replaced, compiles the copies (all nvcc runs started together), holds
each variant that computes the kernel's function against the plain version,
and times every variant in forward then reverse order:

- K5 per layer at ``[1, 64, 481280]`` fp32, d = 1, weights packed once;
- K4 at ``[1, 32, 481280]`` fp32, SnakeBeta;
- K1 at its serving and training shapes in bf16 and fp32 (checked there and
  on a ragged, masked case), beside ``F.scaled_dot_product_attention``; then
  the shipped K1 at the serving shape with ``kv_len`` from 0 to 752 keys: the
  time at 0 keys is the launch's fixed cost, the slope the cost per key.

The ablations take one part of the work out (their results are wrong; only
their times are read): the time a part saves is what it costs inside the
kernel.

Run from the repository root on a machine with a GPU:
    python3 kernel_variants.py k5      (or k4, or k1)
"""

from __future__ import annotations

import ctypes
import math
import re
import sys
import time

import torch
import torch.nn.functional as F

import chip_smoke as cs
from versband_tpu_torch.ops import _build
from versband_tpu_torch.ops import flash_attention as fa
from versband_tpu_torch.ops import fused_act1d as fa1
from versband_tpu_torch.ops import fused_wavenet as fw

TANH = ("__device__ __forceinline__ float sigmoid(float v) "
        "{ return fmaf(0.5f, tanhf(0.5f * v), 0.5f); }")
WAVES = """#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m) mma_tf32(small[m][j], a[m].tail, bh[j][0], bh[j][1]);
  if constexpr (!EXACT_B) {
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_tf32(small[m][j], a[m].head, bt[j][0], bt[j][1]);
  }
"""
GATE_B = "      bv[j][0] = to_float(x0[8 * j]);\n      bv[j][1] = to_float(x1[8 * j]);"
A_LOAD = "  const float4 v = *reinterpret_cast<const float4*>(frag + lane * 16);"
A_CONST = "  const float4 v = make_float4(lane, frag[0], 2.0f, 3.0f);"
# name -> (computes K5's function, [(text, replacement), ...]); each text must occur once
K5_VARIANTS = {
    "shipped": (True, []),
    "TF32 heads rounded (cvt.rna, as K1-K3)": (True, [
        ("      else split_tf32_trunc(b[j][r], bh[j][r], bt[j][r]);",
         "      else split_tf32(b[j][r], bh[j][r], bt[j][r]);"),
        ("""  split_tf32_trunc(v.x, a.head[0], a.tail[0]);
  split_tf32_trunc(v.y, a.head[1], a.tail[1]);
  split_tf32_trunc(v.z, a.head[2], a.tail[2]);
  split_tf32_trunc(v.w, a.head[3], a.tail[3]);""", """  split_tf32(v.x, a.head[0], a.tail[0]);
  split_tf32(v.y, a.head[1], a.tail[1]);
  split_tf32(v.z, a.head[2], a.tail[2]);
  split_tf32(v.w, a.head[3], a.tail[3]);""")]),
    "sigmoid as 1 / (1 + exp(-v))": (True, [(
        TANH, "__device__ __forceinline__ float sigmoid(float v) "
              "{ return 1.0f / (1.0f + expf(-v)); }")]),
    "4 ring stages (3R + A <= 272)": (True, [
        ("constexpr int STAGES = 3;", "constexpr int STAGES = 4;"),
        ("constexpr int MAX_K = 288;", "constexpr int MAX_K = 272;")]),
    "8 warps of 2 x 4 tiles": (True, [("constexpr int WARPS = 16;", "constexpr int WARPS = 8;")]),
    "12 warps of 2 x 2 tiles, 48-sample tiles": (True, [
        ("constexpr int WARPS = 16;", "constexpr int WARPS = 12;"),
        ("constexpr int NT = 64; ", "constexpr int NT = 48; ")]),
    "8 warps of 2 x 2 tiles, 32-sample tiles": (True, [
        ("constexpr int WARPS = 16;", "constexpr int WARPS = 8;"),
        ("constexpr int NT = 64; ", "constexpr int NT = 32; ")]),
    "ablation: no barrier per chunk": (False, [(
        "      __syncthreads();  // this chunk is in; every warp is done with the one before\n",
        "")]),
    "ablation: no X copies (operands left in shared memory)": (False, [(
        "    stage_chunk<T>(p, pr.b, pr.t0, pr.ch, ring + pr.stage * XCfg<T>::STAGE_BYTES);", "")]),
    "ablation: one pass (head.head only)": (False, [(WAVES, "")]),
    "ablation: no tanh, no sigmoid": (False, [
        (TANH, "__device__ __forceinline__ float sigmoid(float v) { return v; }"),
        ("z.x = tanhf(", "z.x = ("), ("z.y = tanhf(", "z.y = (")]),
    "ablation: one pass, gate B not read from shared memory": (False, [
        (WAVES, ""), (GATE_B, "      bv[j][0] = 1.0f + lane;\n      bv[j][1] = 1.0f - j;")]),
    "ablation: one pass, A not read from shared memory": (False, [(WAVES, ""), (A_LOAD, A_CONST)]),
    "ablation: one pass, neither": (False, [
        (WAVES, ""), (A_LOAD, A_CONST),
        (GATE_B, "      bv[j][0] = 1.0f + lane;\n      bv[j][1] = 1.0f - j;")]),
}


SNAKE_RETURN = "  return fmaf(inv_b * s, s, u);\n}"
# name -> (computes K4's function, [(text, replacement), ...]); each text must occur once
K4_VARIANTS = {
    "shipped": (True, []),
    "128 threads, 512-sample tiles": (True, [
        ("constexpr int TILE = 1024; ", "constexpr int TILE = 512; "),
        ("constexpr int THREADS = 256;", "constexpr int THREADS = 128;")]),
    "up to 16 blocks per SM": (True, [
        ("constexpr int MAX_BLOCKS_PER_SM = 8;", "constexpr int MAX_BLOCKS_PER_SM = 16;")]),
    "ablation: no Snake (S = U)": (False, [(SNAKE_RETURN, "  return u;\n}")]),
    "ablation: no x copies (x left in shared memory)": (False, [(
        "    stage_x<T>(p, static_cast<const T*>(p.x) + (it.row / p.C) * p.sxb + it.c * p.sxc, "
        "it.t0, xs);", "    ;")]),
    "ablation: no output stores": (False, [(
        "    if (t + OUTS <= len && ", "    if (t < 0 && ")]),
}


# K1's block shape: m-tiles per warp (MT), WARPS, keys per streamed tile (BN)
# and ring STAGES, constants of its Cfg with a bf16 and an fp32 value
K1_MT = "static constexpr int MT = BF16 ? 2 : 1;"
K1_WARPS = "static constexpr int WARPS = BF16 ? 4 : 8;"
K1_BN = "static constexpr int BN = BF16 ? 64 : 32;"
K1_STAGES = "static constexpr int STAGES = 2;"
K1_VARIANTS = {
    "shipped": (True, []),
    "bf16 64 rows, 4 warps x 1 m-tile, 64-key tiles, 2 stages": (True, [
        (K1_MT, "static constexpr int MT = 1;")]),
    "bf16 128 rows, 4 warps x 2 m-tiles, 32-key tiles, 2 stages": (True, [
        (K1_BN, "static constexpr int BN = 32;")]),
    "bf16 128 rows, 4 warps x 2 m-tiles, 64-key tiles, 3 stages": (True, [
        (K1_STAGES, "static constexpr int STAGES = BF16 ? 3 : 2;")]),
    "fp32 64 rows, 4 warps": (True, [(K1_WARPS, "static constexpr int WARPS = 4;")]),
}


def variant_source(src: str, changes: list) -> str:
    for old, new in changes:
        if src.count(old) != 1:
            raise RuntimeError(f"expected one occurrence of {old[:60]!r}, found {src.count(old)}")
        src = src.replace(old, new)
    return src


def build(name: str, variants: dict, bind, entries: str = "") -> dict:
    """variant -> its library's entry point, bound by ``bind`` (all sources
    written before any compiler starts); prints registers and spills of each
    kernel instance whose mangled name holds ``entries``."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    out_dir = _build.BUILD_ROOT.parent / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    names, sources = {}, {}
    for i, (v, (_, changes)) in enumerate(variants.items()):
        names[f"{name}_{i}"] = v
        sources[f"{name}_{i}"] = out_dir / f"{name}_{i}.cu"
        sources[f"{name}_{i}"].write_text(variant_source(src, changes))
    fns = {}
    for lib_name, (lib, log) in _build.finish(_build.start(sources, out_dir)).items():
        regs, entry, spill = [], "?", "?"
        for line in log.splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                entry = m[1]
            elif m := re.search(r"(\d+) bytes spill stores", line):
                spill = m[1]
            elif (m := re.search(r"Used (\d+) registers", line)) and entries in entry:
                regs.append(f"{'bf16' if 'bfloat' in entry else 'fp32'} {m[1]} registers, "
                            f"{spill} B spilled")
        print(f"[variants] {names[lib_name]}: {'; '.join(regs)}")
        fns[names[lib_name]] = bind(ctypes.CDLL(str(lib.resolve())))
    return fns


def bind_k5(lib):
    fn = lib.vbt_fused_wavenet
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bind_k4(lib):
    fn = lib.vbt_fused_act1d
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_and_time(fns: dict, variants: dict, module, run, ref, tols) -> dict:
    """Hold each variant that computes the kernel's function to the plain
    version; return variant -> its times, forward then reverse order."""
    for name, fn in fns.items():
        if not variants[name][0]:
            continue
        module._FN = fn
        for a, r, tol in zip(run(), ref, tols):
            err = (a - r).abs().max().item()
            if not err <= tol * r.abs().max().item():
                raise AssertionError(f"variant {name} disagrees with the plain version: {err}")
    times = {}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            module._FN = fns[name]
            times.setdefault(name, []).append(cs.cuda_ms(run, 20))
    return times


@torch.no_grad()
def main_k45(which: str, dev, gen) -> None:
    T = cs.T_MEL * cs.HOP
    if which == "k5":
        R, G2, S, A, d = cs.PWG_R, cs.PWG_GATE, cs.PWG_S, cs.PWG_A, 1
        x, c, skip = cs._k5_inputs(gen, dev, 1, T, R, A, S, torch.float32)
        w = cs._k5_weights(dev, R, G2, S, A, d, cs.SEED + d)
        cache = fw.PackCache()
        run = lambda: fw.fused_wavenet_layer(x, c, skip, *w, d, cache)  # noqa: E731
        ref = fw.wavenet_layer_reference(x, c, skip, *w, d)
        tols = cs.K5_TOL[torch.float32]
        bound, by = cs.k5_bound_ms(x, A, S, G2 // 2)
        variants, module = K5_VARIANTS, fw
        fns = build("fused_wavenet", variants, bind_k5)
    else:
        x = torch.randn(1, 32, T, generator=gen, device=dev)
        alpha, beta = cs._snake_params(gen, 32, dev, True, True)
        run = lambda: (fa1.fused_alias_free_snake(x, alpha, beta),)  # noqa: E731
        ref = (fa1.alias_free_snake_reference(x, alpha, beta),)
        tols = (cs.K4_TOL[torch.float32] * max(1.0, ref[0].abs().max().item())
                / ref[0].abs().max().item(),)
        bound, by = cs.k4_bound_ms(x)
        variants, module = K4_VARIANTS, fa1
        fns = build("fused_act1d", variants, bind_k4)
    times = check_and_time(fns, variants, module, run, ref, tols)
    print(f"[variants] {which} x{tuple(x.shape)} fp32, bound {bound:.4f} ms ({by})")
    for name, t in times.items():
        print(f"[variants]   {t[0]:.4f} / {t[1]:.4f} ms ({bound / min(t):.1%} of bound)  {name}")


def main_k1(dev, gen) -> None:
    fns = build("flash_attn_fwd", K1_VARIANTS, fa.bind_fwd, entries="Li96E")

    def qkv(B, Tq, Tk, H, D, dtype):
        return [torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype)
                for T in (Tq, Tk, Tk)]

    shapes = {"serving": (2, cs.T_LAT, 8, 96), "training": (cs.TRAIN_B, cs.T_TRAIN, 8, 96)}
    points = {(name, dtype): qkv(B, T, T, H, D, dtype) for name, (B, T, H, D) in shapes.items()
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
        print(f"[variants] k1 {shape} {dt} q{tuple(q.shape)}: scaled_dot_product_attention "
              f"{lib:.4f} ms, bound {bound:.4f} ms ({by})")
        for name in fns:
            t = times[(name, (shape, dtype))]
            print(f"[variants]   {t[0]:.4f} / {t[1]:.4f} ms ({bound / min(t):.1%} of bound)"
                  f"  {name}")
    fa._FN = fns["shipped"]
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = points[("serving", dtype)]
        row = []
        for n in (0, 64, 128, 256, 384, 512, 752):
            lens = torch.full((q.shape[0],), n, dtype=torch.int32, device=dev)
            row.append(f"{n}: {cs.cuda_ms(lambda: fa.flash_attention(q, k, v, lens), 50):.4f}")
        print(f"[variants] k1 shipped, serving {str(dtype)[6:]}, ms by kv_len: " + ", ".join(row))


def main(which: str) -> None:
    if which not in ("k1", "k4", "k5"):
        raise SystemExit("usage: python3 kernel_variants.py k1|k4|k5")
    smi = cs.phase_card()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    t0 = time.perf_counter()
    if which == "k1":
        main_k1(dev, gen)
    else:
        main_k45(which, dev, gen)
    print(f"[variants] {which}: built, checked and timed in {time.perf_counter() - t0:.1f} s")
    print(smi)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
