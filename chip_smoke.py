#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Drives the port's two paths at the shipped widths of configs/vocal2music.yaml
(random weights from a seed) and holds every CUDA kernel of them against its
plain PyTorch version on the card:

* serving -- Band-MoE DiT inside the CFG Euler sampler, VAE decode,
  HiFi-GAN -- through ``PipelinedGenerator``;
* training -- the CFM step (frozen-VAE encode, OT-CFM + load-balance loss,
  backward through the flash-attention kernels, clip, AdamW) -- through
  ``CFMTrainer.fit``.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the card: requires CUDA; prints ``nvidia-smi`` name and power limit;
  2. builds the kernels from ``versband_tpu_torch/ops/csrc`` (nvcc, sm_90a);
  3. K1 (flash-attention forward), out and log-sum-exp, against its plain
     version at the serving and training shapes and on ragged, masked and
     scaled cases; times kernel, plain version and
     ``F.scaled_dot_product_attention`` (a yardstick only);
  4. K2 (dQ) and K3 (dK, dV), the flash-attention backward, against the
     plain backward at the training and serving shapes and on ragged,
     masked and scaled cases, fp32 and bf16; times each kernel, its plain
     version and the backward of ``F.scaled_dot_product_attention``;
  5. the shipped-width DiT forward (fp32) on the card against the CPU, and
     the VAE decoder and HiFi-GAN likewise at a short length;
  6. serves 3 requests (20 s clips, bf16, CFG 2.0, 25 steps) and checks the
     waveforms and that every DiT self-attention went through K1;
  7. trains 5 steps at full width (fp32, batch 8, 1500-frame mels padded to
     1536) through ``CFMTrainer.fit`` with the shipped LR scaling and
     schedule; checks finite losses, moved weights, a ``last`` checkpoint
     with ``scale_factor``, and 4 K1 + 4 K2 + 4 K3 launches per step;
  8. one train step at full width (batch 2) on the card and on the CPU from
     the same weights, batch and draws: loss and gradients agree;
  9. prints the kernel table as JSON, then ``{"ok": true, ...}`` last.
"""

from __future__ import annotations

import copy
import json
import math
import re
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from versband_tpu_torch.models.autoencoder import AutoencoderKL
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.models.dit import BandMoeDiT
from versband_tpu_torch.ops import _build
from versband_tpu_torch.ops import flash_attention as fa
from versband_tpu_torch.sample.pipeline import PipelinedGenerator
from versband_tpu_torch.train.callbacks import Callback
from versband_tpu_torch.train.lr_schedules import scale_base_lr
from versband_tpu_torch.train.state import TrainState, make_adamw
from versband_tpu_torch.train.step import make_cfm_train_step
from versband_tpu_torch.train.trainer import CFMTrainer
from versband_tpu_torch.vocoder.hifigan import HifiGAN, HifiGanGenerator

SEED = 0
SR, HOP = 24000, 320
T_MEL, T_LAT = 1504, 752
STEPS, CFG_SCALE = 25, 2.0
N_REQUESTS = 3
DTYPE = torch.bfloat16  # serving dtype
# configs/vocal2music.yaml model.params.unet_config / first_stage_config
DIT = dict(in_channels=20, ori_dim=1024, context_dim=768, hidden_size=768, num_heads=8,
           depth=4, max_len=1500, num_experts=4, use_flash=True)
VAE = dict(embed_dim=20, ddconfig=dict(
    double_z=True, in_channels=80, out_ch=80, z_channels=20, kernel_size=5, ch=384,
    ch_mult=[1, 2, 4], num_res_blocks=2, attn_layers=[3], down_layers=[0], dropout=0.0))
LAUNCHES_PER_CLIP = (STEPS - 1) * DIT["depth"]  # one K1 per block per Euler step
# training: data.params (batch 8, 1500-frame crops), model.base_learning_rate
# scaled as accum * devices * batch * base, and model.params.scheduler_config
TRAIN_B, TRAIN_T_MEL, TRAIN_STEPS = 8, 1500, 5
T_TRAIN = 768  # latent frames of a 1500-frame mel padded to the 128-frame bucket
BASE_LR = 3.0e-06
SCHEDULE = dict(target="versband_tpu.train.lr_schedules.LambdaLinearScheduler",
                params=dict(warm_up_steps=[10000], cycle_lengths=[10000000000000],
                            f_start=[1.0e-06], f_max=[1.0], f_min=[1.0]))

# K1 against its plain version: fp32 differs by summation order only; bf16
# rounds the probabilities and the output (outputs are O(1)).
K1_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# K1's log-sum-exp against the plain one, absolute, on rows with a valid key:
# both compute it in fp32 from the same (widened) inputs, in another order.
K1_LSE_TOL = 1e-4
# K2/K3 against the plain backward, as max|kernel - plain| / max|plain|: fp32
# sums in another order over up to 768 rows or keys; bf16 inputs are widened
# to fp32 on both sides and each gradient rounded to bf16 once (half an ulp
# is 2^-9 of a value, and the largest values set the scale).
K23_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# fp32 modules on the card against the CPU (TF32 off): summation order over
# 768-1536-wide products through 4 blocks / ~30 conv layers.
MODULE_TOL = 2e-3
# One fp32 train step, card against CPU: the loss relative to itself, and
# for each parameter max|grad_card - grad_cpu| relative to that parameter's
# largest CPU gradient, or to STEP_GRAD_FLOOR x the largest of all where its
# own is smaller (summation order through the VAE encoder, 4 blocks forward
# and backward, K1-K3).
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_GRAD_FLOOR = 1e-4, 1e-3, 1e-3

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 FMA, HBM3.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, dtype: torch.dtype = torch.float32) -> tuple:
    """Least time of a function on this card: the larger of its FLOPs over
    the peak rate for ``dtype`` and its bytes over HBM; and what bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound_ms(q, k, v, kv_len) -> tuple:
    """K1's bound for these inputs: 4 FLOP per (query, valid key, dim); q, k,
    v read once, out and lse written once."""
    B, Tq, H, D = q.shape
    keys = k.shape[1] * B if kv_len is None else int(kv_len.clamp(0, k.shape[1]).sum())
    flops = 4 * H * Tq * keys * D
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size() + B * H * Tq * 4
    return bound_ms(flops, nbytes, q.dtype)


def bwd_bound_ms(q, k, kv_len, kernel: str) -> tuple:
    """Least time of K2 ("dq": 6 FLOP per (query, valid key, dim)) or K3
    ("dkv": 8), with q, k, v, dO, lse and delta read once and the gradients
    written once."""
    B, Tq, H, D = q.shape
    keys = k.shape[1] * B if kv_len is None else int(kv_len.clamp(0, k.shape[1]).sum())
    flops = (6 if kernel == "dq" else 8) * H * Tq * keys * D
    e = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * e + 2 * B * H * Tq * 4
    nbytes += q.numel() * e if kernel == "dq" else 2 * k.numel() * e
    return bound_ms(flops, nbytes, q.dtype)


def reset_launches() -> None:
    fa.LAUNCHES = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0


def launches() -> tuple:
    return fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(sorted(libs)))
    for name, path in libs.items():  # ptxas -v: registers and spills per kernel
        log = path.with_suffix(".log")
        entry, spills = "?", "?"
        for line in (log.read_text().splitlines() if log.exists() else []):
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                entry = m[1]
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                spills = f"{m[1]}/{m[2]} B"
            elif m := re.search(r"Used (\d+) registers", line):
                print(f"[build] {name}: {entry}: {m[1]} registers, spill stores/loads {spills}")


def phase_k1(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(B, Tq, Tk, H, D, dtype):
        return [torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype)
                for T in (Tq, Tk, Tk)]

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases += [("serving", qkv(2, T_LAT, T_LAT, 8, 96, dtype), None, None),
                  ("training", qkv(TRAIN_B, T_TRAIN, T_TRAIN, 8, 96, dtype), None, None),
                  ("tq!=tk d64", qkv(2, 300, 517, 4, 64, dtype), None, None),
                  ("varlen+0", qkv(3, 200, T_LAT, 8, 96, dtype), [T_LAT, 0, 301], None),
                  ("scale d128", qkv(2, 129, 250, 2, 128, dtype), None, 0.3)]
    errs = {}
    for name, (q, k, v), lens, scale in cases:
        kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
        out, lse = fa.flash_attention_fwd(q, k, v, kv_len, scale)
        s = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
        ref, ref_lse = fa._reference_fwd(q, k, v, kv_len, s)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rows = slice(None) if lens is None else kv_len > 0  # a row with no key has no lse
        lse_err = (lse[rows] - ref_lse[rows]).abs().max().item()
        tol = K1_TOL[q.dtype]
        dt = str(q.dtype).replace("torch.", "")
        print(f"[k1] {name:11s} {dt:8s} q{tuple(q.shape)} k{tuple(k.shape)} "
              f"max|kernel-plain| out {err:.3e} (tol {tol:g}), lse {lse_err:.3e} "
              f"(tol {K1_LSE_TOL:g})")
        if not (err <= tol and lse_err <= K1_LSE_TOL and torch.isfinite(lse).all()):
            raise AssertionError(f"K1 disagrees with its plain version on {name} {dt}: "
                                 f"out {err}, lse {lse_err}")
        if lens is not None and (out[1] != 0).any():
            raise AssertionError("K1: kv_len == 0 row is not 0")
        errs[(name, q.dtype)] = err

    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = qkv(2, T_LAT, T_LAT, 8, 96, dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 100)
        plain = cuda_ms(lambda: fa.flash_attention_reference(q, k, v), 20)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 100)
        bound, by = k1_bound_ms(q, k, v, None)
        dt = str(dtype).replace("torch.", "")
        print(f"[k1] serving {dt}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"scaled_dot_product_attention {lib:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"kernel at {bound / ms:.1%} of bound")
        timing[dtype] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
    q, k, v = qkv(TRAIN_B, T_TRAIN, T_TRAIN, 8, 96, torch.float32)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
    bound, by = k1_bound_ms(q, k, v, None)
    print(f"[k1] training float32 q{tuple(q.shape)}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
          f"({by}), kernel at {bound / ms:.1%} of bound")
    return {"max_abs_err": errs[("serving", torch.bfloat16)], **timing[torch.bfloat16]}


def phase_k23(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def inputs(B, Tq, Tk, H, D, dtype):
        return [torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype)
                for T in (Tq, Tk, Tk, Tq)]  # q, k, v, dO

    cases = [("training", (TRAIN_B, T_TRAIN, T_TRAIN, 8, 96), None, None),
             ("serving", (2, T_LAT, T_LAT, 8, 96), None, None),
             ("tq!=tk d64", (2, 300, 517, 4, 64), None, None),
             ("varlen+0", (3, 200, T_LAT, 8, 96), [T_LAT, 0, 301], None),
             ("scale d128", (2, 129, 250, 2, 128), None, 0.3)]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).replace("torch.", "")
        for name, shape, lens, scale in cases:
            q, k, v, dout = inputs(*shape, dtype)
            kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
            out, lse = fa.flash_attention_fwd(q, k, v, kv_len, scale)
            got = fa.flash_attention_bwd(q, k, v, kv_len, out, lse, dout, scale)
            ref = fa.flash_attention_bwd_reference(q, k, v, kv_len, out, lse, dout, scale)
            torch.cuda.synchronize()
            row = {}
            for gname, a, b in zip(("dq", "dk", "dv"), got, ref):
                err = (a.float() - b.float()).abs().max().item()
                big = b.float().abs().max().item()
                tol = K23_TOL[dtype] * big
                row[gname] = err
                if not (err <= tol and big > 0 and torch.isfinite(a).all()):
                    raise AssertionError(f"K2/K3 {gname} disagrees with the plain backward on "
                                         f"{name} {dt}: {err} > {tol}")
            if lens is not None and any((g[1] != 0).any() for g in got):
                raise AssertionError("K2/K3: a kv_len == 0 row has nonzero gradients")
            print(f"[k23] {name:11s} {dt:8s} q{tuple(q.shape)} k{tuple(k.shape)} "
                  f"max|kernel-plain| dq {row['dq']:.3e} dk {row['dk']:.3e} dv {row['dv']:.3e}"
                  f" (tol {K23_TOL[dtype]:g} x max|plain|)")
            errs[(name, dtype)] = row

    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).replace("torch.", "")
        q, k, v, dout = inputs(TRAIN_B, T_TRAIN, T_TRAIN, 8, 96, dtype)
        scale = 1.0 / math.sqrt(96)
        out, lse = fa.flash_attention_fwd(q, k, v)
        delta = fa._delta(out, dout)
        args = (q, k, v, None, lse, delta, dout, scale)
        dq_ms = cuda_ms(lambda: fa.flash_attention_bwd_dq(*args), 20)
        dkv_ms = cuda_ms(lambda: fa.flash_attention_bwd_dkv(*args), 20)
        delta_ms = cuda_ms(lambda: fa._delta(out, dout), 20)
        plain_dq = cuda_ms(lambda: fa.flash_attention_bwd_dq_reference(*args), 5)
        plain_dkv = cuda_ms(lambda: fa.flash_attention_bwd_dkv_reference(*args), 5)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt)
        dot = dout.transpose(1, 2)
        lib = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True), 20)
        bq, bq_by = bwd_bound_ms(q, k, None, "dq")
        bkv, bkv_by = bwd_bound_ms(q, k, None, "dkv")
        print(f"[k23] training {dt}: K2 {dq_ms:.4f} ms (plain {plain_dq:.4f}, bound {bq:.4f} "
              f"{bq_by}, {bq / dq_ms:.1%} of bound); K3 {dkv_ms:.4f} ms (plain "
              f"{plain_dkv:.4f}, bound {bkv:.4f} {bkv_by}, {bkv / dkv_ms:.1%} of bound); "
              f"delta {delta_ms:.4f} ms; K2+K3+delta {dq_ms + dkv_ms + delta_ms:.4f} ms against "
              f"the scaled_dot_product_attention backward {lib:.4f} ms")
        timing[dtype] = dict(
            dq=dict(ms=dq_ms, plain_ms=plain_dq, bound_ms=bq, bound_by=bq_by, library_ms=lib),
            dkv=dict(ms=dkv_ms, plain_ms=plain_dkv, bound_ms=bkv, bound_by=bkv_by,
                     library_ms=lib))
    train_err = errs[("training", torch.float32)]
    t32 = timing[torch.float32]
    return {"dq": {"max_abs_err": train_err["dq"], **t32["dq"]},
            "dkv": {"max_abs_err": max(train_err["dk"], train_err["dv"]), **t32["dkv"]}}


def perturb_zero_init(model: torch.nn.Module, seed: int, std: float = 0.02) -> None:
    """adaLN-zero layers and attention gates start at 0 (the DiT would output
    0); give them small random values."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "adaLN" in name or "final_layer" in name or name.endswith("gate"):
                p.copy_((torch.randn(p.shape, generator=g) * std).to(p.device, p.dtype))


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float().cpu() - b.float().cpu()).abs().max().item()


@torch.no_grad()
def phase_modules(dev) -> None:
    torch.manual_seed(SEED)
    cpu = BandMoeDiT(**DIT).eval()
    perturb_zero_init(cpu, SEED)
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.randn(2, 20, T_LAT).astype(np.float32))
    t = torch.tensor([300.0, 700.0])
    ctx = {"c_concat": {"midi": torch.from_numpy(rng.randint(0, 130, (2, 1, T_MEL))),
                        "beats": torch.from_numpy(rng.randint(0, 3, (2, 1, T_MEL)))},
           "c_crossattn": torch.from_numpy(rng.randn(2, 80, 1024).astype(np.float32))}
    gctx = {"c_concat": {k: v.to(dev) for k, v in ctx["c_concat"].items()},
            "c_crossattn": ctx["c_crossattn"].to(dev)}
    before = fa.LAUNCHES
    out_gpu, _ = gpu(x.to(dev), t.to(dev), gctx)
    torch.cuda.synchronize()
    if fa.LAUNCHES - before != DIT["depth"]:
        raise AssertionError(f"DiT forward launched K1 {fa.LAUNCHES - before} times, "
                             f"expected {DIT['depth']}")
    out_cpu, _ = cpu(x, t, ctx)
    err = _max_diff(out_gpu, out_cpu)
    print(f"[modules] BandMoeDiT fp32 [2,20,{T_LAT}] card (K1) vs CPU (plain): "
          f"max|d| {err:.3e} (tol {MODULE_TOL:g}), |out|max {out_cpu.abs().max():.3f}")
    if not err <= MODULE_TOL:
        raise AssertionError(f"DiT on the card disagrees with the CPU: {err}")

    torch.manual_seed(SEED + 1)
    vae = AutoencoderKL(**VAE).eval()
    voc = HifiGanGenerator().eval()
    z = torch.from_numpy(rng.randn(1, 20, 48).astype(np.float32))
    mel_cpu = vae.decode(z)
    wav_cpu = voc(mel_cpu)
    vae.to(dev)
    voc.to(dev)
    mel_gpu = vae.decode(z.to(dev))
    wav_gpu = voc(mel_cpu.to(dev))
    for name, a, b in (("VAE decode", mel_gpu, mel_cpu), ("HiFi-GAN", wav_gpu, wav_cpu)):
        err = _max_diff(a, b)
        print(f"[modules] {name} fp32 {tuple(b.shape)} card vs CPU: max|d| {err:.3e} "
              f"(tol {MODULE_TOL:g})")
        if not err <= MODULE_TOL:
            raise AssertionError(f"{name} on the card disagrees with the CPU: {err}")


def build_serving(dev, n_requests: int = N_REQUESTS):
    """The shipped-width serving models in bf16 (random weights from SEED),
    the unconditional branch, and ``n_requests`` (cond, generator) requests."""
    torch.manual_seed(SEED)
    cfm = CFM(unet_config=dict(target="versband_tpu.models.dit.BandMoeDiT", params=DIT),
              first_stage_config=dict(target="versband_tpu.models.autoencoder.AutoencoderKL",
                                      params=VAE),
              mel_dim=20, scale_factor=1.0, device=dev, dtype=DTYPE)
    perturb_zero_init(cfm.model, SEED)
    voc = HifiGAN(device=dev, dtype=DTYPE, seed=SEED)

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    uncond = {"caption": torch.zeros(1, 80, 1024, device=dev, dtype=DTYPE),
              "acoustic": {"midi": torch.full((1, 1, T_MEL), 128, device=dev),
                           "beats": torch.full((1, 1, T_MEL), 2, device=dev)}}
    requests = []
    for i in range(n_requests):
        cond = {"caption": torch.randn(1, 80, 1024, generator=gen, device=dev).to(DTYPE),
                "acoustic": {"midi": torch.randint(0, 128, (1, 1, T_MEL), generator=gen,
                                                   device=dev),
                             "beats": torch.randint(0, 2, (1, 1, T_MEL), generator=gen,
                                                    device=dev)}}
        requests.append((cond, torch.Generator(device=dev).manual_seed(SEED + 100 + i)))
    return cfm, voc, uncond, requests


def phase_serve(dev) -> dict:
    cfm, voc, uncond, requests = build_serving(dev)
    events, launches = [], []

    def sample_fn(cond, generator):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        events.append(ev)
        n0 = fa.LAUNCHES
        ev[0].record()
        z = cfm.sample_cfg(cond, CFG_SCALE, uncond, generator, timesteps=STEPS)
        ev[1].record()
        launches.append(fa.LAUNCHES - n0)
        return z

    def decode_fn(z):
        mel = cfm.decode_first_stage(z)
        events[-1][2].record()
        return mel

    def vocode_fn(mel):
        wav = voc.model(mel)[0]
        events[-1][3].record()
        return wav

    pipe = PipelinedGenerator(sample_fn, decode_fn, vocode_fn, depth=2)
    torch.cuda.synchronize()
    fa.LAUNCHES = 0  # count only the main path's launches
    t0 = time.perf_counter()
    with torch.inference_mode():
        wavs = list(pipe.generate(requests))
    wall = time.perf_counter() - t0
    main_launches = fa.LAUNCHES

    n = T_MEL * HOP
    for i, w in enumerate(wavs):
        if w.shape != (n,) or not np.isfinite(w).all() or not w.std() > 0:
            raise AssertionError(f"request {i}: waveform shape {w.shape}, "
                                 f"finite {np.isfinite(w).all()}, std {w.std()}")
    if launches != [LAUNCHES_PER_CLIP] * N_REQUESTS or main_launches != sum(launches):
        raise AssertionError(f"K1 launches per request {launches}, total {main_launches}; "
                             f"expected {LAUNCHES_PER_CLIP} each")
    audio_s = n / SR
    rows = []
    for i, ev in enumerate(events):
        r = dict(sample=ev[0].elapsed_time(ev[1]), decode=ev[1].elapsed_time(ev[2]),
                 vocode=ev[2].elapsed_time(ev[3]), total=ev[0].elapsed_time(ev[3]))
        rows.append(r)
        print(f"[serve] request {i}: waveform [{n}] finite, K1 launches {launches[i]}; "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in r.items()))
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    print(f"[serve] per clip (median of {N_REQUESTS}, device time): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items())
          + f"; rtf {audio_s / (med['total'] / 1e3):.2f}x for {audio_s:.3f} s of audio")
    print(f"[serve] host wall for {N_REQUESTS} pipelined requests {wall * 1e3:.1f} ms "
          f"({audio_s * N_REQUESTS / wall:.2f}x real time)")
    return {"launches": main_launches}


def training_configs():
    return (dict(target="versband_tpu.models.dit.BandMoeDiT", params=DIT),
            dict(target="versband_tpu.models.autoencoder.AutoencoderKL", params=VAE))


class InMemoryData:
    """Batches in the shipped layout (mel ``image``, caption embeddings,
    midi/beats ids at mel rate), made in bulk from a seed."""

    def __init__(self, n: int, B: int, t_mel: int, seed: int):
        rng = np.random.RandomState(seed)
        self.batches = [{
            "image": rng.randn(B, 80, t_mel).astype(np.float32),
            "caption": {"caption": rng.randn(B, 80, DIT["ori_dim"]).astype(np.float32),
                        "acoustic": {"midi": rng.randint(0, 128, (B, 1, t_mel)),
                                     "beats": rng.randint(0, 2, (B, 1, t_mel))}}}
            for _ in range(n)]

    def train_dataloader(self):
        return self.batches


class _Probe(Callback):
    """Per step: the metrics and the launch counts after it."""

    def __init__(self):
        self.metrics, self.counts = [], []

    def on_train_batch_end(self, trainer, batch, metrics, step):
        self.metrics.append(metrics)
        self.counts.append(launches())


def phase_train(dev) -> dict:
    torch.manual_seed(SEED)
    unet, vae = training_configs()
    cfm = CFM(unet_config=unet, first_stage_config=vae, mel_dim=DIT["in_channels"],
              scale_by_std=True, scheduler_config=SCHEDULE, device=dev, dtype=torch.float32)
    perturb_zero_init(cfm.model, SEED)
    data = InMemoryData(TRAIN_STEPS, TRAIN_B, TRAIN_T_MEL, SEED + 20)
    logdir = Path("build") / "chip_smoke_train"
    shutil.rmtree(logdir, ignore_errors=True)
    probe = _Probe()
    trainer = CFMTrainer(cfm, None, learning_rate=scale_base_lr(BASE_LR, TRAIN_B, 1, 1),
                         logdir=str(logdir),
                         max_steps=TRAIN_STEPS, max_epochs=1, use_tensorboard=False,
                         log_every_n_steps=10 ** 9, callbacks=[probe], seed=SEED)
    events = []
    step_fn = trainer.train_step

    def timed_step(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = step_fn(*args, **kw)
        ev[1].record()
        events.append(ev)
        return out

    trainer.train_step = timed_step
    before = {k: v.detach().clone() for k, v in cfm.model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # count only the main path's launches
    t0 = time.perf_counter()
    trainer.fit(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()

    per_step = [tuple(b - a for a, b in zip((0, 0, 0) if i == 0 else probe.counts[i - 1], c))
                for i, c in enumerate(probe.counts)]
    depth = DIT["depth"]
    if trainer.global_step != TRAIN_STEPS or per_step != [(depth, depth, depth)] * TRAIN_STEPS:
        raise AssertionError(f"training: {trainer.global_step} steps, K1/K2/K3 launches per "
                             f"step {per_step}; expected {depth} each per step")
    for i, m in enumerate(probe.metrics):
        vals = {k: v.item() for k, v in m.items()}
        if not all(math.isfinite(x) for x in vals.values()):
            raise AssertionError(f"training step {i + 1}: non-finite metrics {vals}")
        print(f"[train] step {i + 1}: " + ", ".join(f"{k} {x:.5f}" for k, x in vals.items())
              + f"; K1/K2/K3 launches {per_step[i]}; device {events[i][0].elapsed_time(events[i][1]):.2f} ms")
    moved, changed, total = 0.0, 0, 0
    for k, v in cfm.model.state_dict().items():
        d = (v - before[k]).abs()
        moved, changed, total = max(moved, d.max().item()), changed + int((d > 0).sum()), \
            total + d.numel()
    meta_path = logdir / "checkpoints" / "last_step.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    if not (moved > 0 and (logdir / "checkpoints" / "last.pt").exists()
            and meta.get("step") == TRAIN_STEPS
            and meta.get("scale_factor") == cfm.scale_factor != 1.0):
        raise AssertionError(f"training: max|dparam| {moved}, checkpoint meta {meta}")
    step_ms = [events[i][0].elapsed_time(events[i][1]) for i in range(1, TRAIN_STEPS)]
    med = statistics.median(step_ms)
    print(f"[train] full width fp32, batch {TRAIN_B}, mel {TRAIN_T_MEL} -> latent {T_TRAIN}: "
          f"{trainer.global_step} steps, scale_factor {cfm.scale_factor:.5f}, weights moved "
          f"(max|d| {moved:.3e}, {changed / total:.1%} of elements), checkpoint 'last' written")
    print(f"[train] device time per step (median of steps 2-{TRAIN_STEPS}) {med:.2f} ms, "
          f"{1e3 / med:.3f} steps/s; host wall for fit {wall * 1e3:.1f} ms (first step "
          f"and scale_by_std included); peak memory {peak / 2 ** 30:.2f} GiB "
          f"(max_memory_allocated)")
    print(f"[train] launches on this path: K1 {counts[0]}, K2 {counts[1]}, K3 {counts[2]}")
    shutil.rmtree(logdir, ignore_errors=True)
    return {"launches": counts}


def phase_grad_parity(dev) -> None:
    """One make_cfm_train_step step, card (K1-K3) against CPU (plain versions)."""
    B, t_mel = 2, 2 * T_TRAIN
    torch.manual_seed(SEED + 2)
    unet, vae = training_configs()
    cpu = CFM(unet_config=unet, first_stage_config=vae, mel_dim=DIT["in_channels"],
              scale_by_std=False, scale_factor=0.9, device="cpu")
    perturb_zero_init(cpu.model, SEED + 2)
    gpu = copy.deepcopy(cpu)
    gpu.device = dev
    gpu.model.to(dev)
    gpu.first_stage.to(dev)
    rng = np.random.RandomState(SEED + 3)
    batch = {"image": rng.randn(B, 80, t_mel).astype(np.float32),
             "caption": rng.randn(B, 80, DIT["ori_dim"]).astype(np.float32),
             "midi": rng.randint(0, 128, (B, 1, t_mel)), "beats": rng.randint(0, 2, (B, 1, t_mel))}
    z, c = VAE["embed_dim"], DIT["in_channels"]
    draws = {"posterior": rng.randn(B, z, T_TRAIN).astype(np.float32),
             "t": np.array([137, 802]), "noise": rng.randn(B, c, T_TRAIN).astype(np.float32),
             "gumbel": [rng.gumbel(size=s).astype(np.float32)
                        for s in cpu.model.gumbel_shapes(B, T_TRAIN)]}
    results = []
    for cfm, device in ((gpu, dev), (cpu, torch.device("cpu"))):
        state = TrainState(cfm.model, make_adamw(2.4e-5, grad_clip=1.0))
        grads = {}
        apply = state.apply_gradients

        def snapshot_then_apply(state=state, grads=grads, apply=apply):
            grads.update({k: p.grad.detach().float().cpu().clone()
                          for k, p in state.named.items() if p.grad is not None})
            return apply()

        state.apply_gradients = snapshot_then_apply
        given = {"posterior": torch.from_numpy(draws["posterior"]).to(device),
                 "t": torch.from_numpy(draws["t"]).to(device),
                 "noise": torch.from_numpy(draws["noise"]).to(device),
                 "gumbel": iter(torch.from_numpy(g).to(device) for g in draws["gumbel"])}
        n0 = launches()
        metrics = make_cfm_train_step(cfm)(
            state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()}, given=given)
        if device.type == "cuda":
            torch.cuda.synchronize()
            n = tuple(b - a for a, b in zip(n0, launches()))
            if n != (DIT["depth"],) * 3:
                raise AssertionError(f"card step launched K1/K2/K3 {n} times")
        results.append(({k: v.item() for k, v in metrics.items()}, grads))
    (m_gpu, g_gpu), (m_cpu, g_cpu) = results
    if set(g_gpu) != set(g_cpu):
        raise AssertionError(f"card and CPU differ in the parameters with a gradient: "
                             f"{sorted(set(g_gpu) ^ set(g_cpu))}")
    big = max(g.abs().max().item() for g in g_cpu.values())
    # per parameter: max|dgrad| over its own scale (floored), and the worst of them
    rel = {k: (g_gpu[k] - g).abs().max().item() / max(g.abs().max().item(),
                                                       STEP_GRAD_FLOOR * big)
           for k, g in g_cpu.items()}
    worst = max(rel, key=rel.get)
    lerr = abs(m_gpu["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    qkv_names = [f"layers.{i}.attention.{w}.weight" for i in range(DIT["depth"])
                 for w in ("wq", "wk", "wv")]
    attn = min(g_gpu[k].abs().max().item() for k in qkv_names)
    attn_rel = max(rel[k] for k in qkv_names)
    print(f"[grad] one fp32 train step, batch {B}, latent {T_TRAIN}, card (K1-K3) vs CPU "
          f"(plain): loss {m_gpu['loss']:.6f} vs {m_cpu['loss']:.6f} (rel {lerr:.2e}, tol "
          f"{STEP_LOSS_TOL:g}); per parameter max|dgrad| / max(max|grad|, {STEP_GRAD_FLOOR:g} x "
          f"{big:.3e}): worst {rel[worst]:.2e} ({worst}), worst of the self-attention "
          f"wq/wk/wv {attn_rel:.2e} (tol {STEP_GRAD_TOL:g}); smallest max|grad| of the card's "
          f"wq/wk/wv {attn:.3e}")
    if not (lerr <= STEP_LOSS_TOL and rel[worst] <= STEP_GRAD_TOL and attn > 0):
        raise AssertionError("train step on the card disagrees with the CPU")


def main() -> None:
    smi = phase_card()
    dev = torch.device("cuda")
    phase_build()
    k1 = phase_k1(dev)
    k23 = phase_k23(dev)
    phase_modules(dev)
    served = phase_serve(dev)
    trained = phase_train(dev)
    phase_grad_parity(dev)
    n_train = trained["launches"]
    bwd_src = "versband_tpu_torch/ops/csrc/flash_attn_bwd.cu"
    table = [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "versband_tpu_torch/ops/csrc/flash_attn_fwd.cu",
         "replaces": "versband_tpu/ops/flash_attention.py:57",
         "launches": served["launches"] + n_train[0], **k1},
        {"name": "flash_attn_bwd_dq", "route": "cuda", "source": bwd_src,
         "replaces": "versband_tpu/ops/flash_attention.py:162", "launches": n_train[1],
         **k23["dq"]},
        {"name": "flash_attn_bwd_dkv", "route": "cuda", "source": bwd_src,
         "replaces": "versband_tpu/ops/flash_attention.py:196", "launches": n_train[2],
         **k23["dkv"]},
    ]
    print(f"kernels: {[k['name'] for k in table]}; K1 launches: serving {served['launches']}, "
          f"training {n_train[0]}")
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
