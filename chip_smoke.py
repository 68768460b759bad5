#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Drives the port's paths at the shipped widths of configs/vocal2music.yaml
(random weights from a seed) and holds every CUDA kernel of them against its
plain PyTorch version on the card:

* serving -- Band-MoE DiT inside the CFG Euler sampler, VAE decode, then the
  vocoder as ``build_vocoder`` builds it for ``--vocoder hifigan`` (bf16),
  ``bigvgan`` (fp32, K4 in every activation) and ``pwg`` (fp32, K5 in every
  residual layer) -- through ``PipelinedGenerator``;
* training -- the CFM step (frozen-VAE encode, OT-CFM + load-balance loss,
  backward through the flash-attention kernels, clip, AdamW) -- through
  ``CFMTrainer.fit``.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the card: requires CUDA; prints ``nvidia-smi`` name and power limit;
  2. builds the kernels from ``versband_tpu_torch/ops/csrc`` (nvcc, sm_90a);
     prints each kernel's registers and spills, and fails if a head-dim-96
     instance of K1-K3 spills;
  3. K1 (flash-attention forward), out and log-sum-exp, against its plain
     version at the serving and training shapes and on ragged, masked and
     scaled cases, fp32 and bf16, with bit-equal results over two runs; times
     kernel, plain version and ``F.scaled_dot_product_attention`` (a
     yardstick only) at both shapes in both types;
  4. K2 (dQ) and K3 (dK, dV), the flash-attention backward, against the
     plain backward at the training and serving shapes and on ragged,
     masked and scaled cases, fp32 and bf16, with bit-equal results over two
     runs; times each kernel, its plain version and the backward of
     ``F.scaled_dot_product_attention`` at the training and serving shapes;
  5. K4 (fused alias-free Snake) against its plain version at the four
     BigVGAN serving shapes, Snake and SnakeBeta, logscale on and off, B = 2
     and T of 1, 5 and 37, a strided input, fp32 and bf16; times kernel and
     plain version at each serving shape;
  6. K5 (fused WaveNet layer) against its plain version at full width and
     T = 481,280 for every dilation of the config (1..512), and at B = 2 on a
     ragged T and a T shorter than 2d, fp32 and bf16, with bit-equal results
     over two runs; times one layer (weights packed once, as a
     ``ResidualBlock`` keeps them) against the three-pass TF32 bound (the
     fp32 FMA bound beside it);
     where ``build/parent`` holds an unpacked tree of an earlier commit
     (``git archive``), phases 5 and 6 also build that tree's K4 and K5 from
     its sources and time them on the same inputs, beside these;
  7. the shipped-width DiT forward (fp32) on the card against the CPU, and
     the VAE decoder, HiFi-GAN, BigVGAN (73 K4) and PWG (30 K5) likewise at
     a short length;
  8. serves 3 requests (20 s clips, bf16 sampler and decoder, CFG 2.0, 25
     steps) once per vocoder family (hifigan, bigvgan, pwg) and checks the
     waveforms and the launches per clip: 96 K1, and 73 K4 (bigvgan) or 30
     K5 (pwg);
  9. trains 5 steps at full width (fp32, batch 8, 1500-frame mels padded to
     1536) through ``CFMTrainer.fit`` with the shipped LR scaling and
     schedule; checks finite losses, moved weights, a ``last`` checkpoint
     with ``scale_factor``, and 4 K1 + 4 K2 + 4 K3 launches per step;
 10. one train step at full width (batch 2) on the card and on the CPU from
     the same weights, batch and draws: loss and gradients agree;
 11. [cli] the inference CLI, ``versband_tpu_torch.cli.generate.main``, in
     this process on the card with ``configs/vocal2music.yaml`` as committed
     (read by the port's own YAML parser): run from a scratch directory that
     holds ``useful_ckpts/flan-t5-large`` (flan-t5-large's published geometry,
     random weights from SEED written as ``model.safetensors``, and a
     Unigram ``tokenizer.json`` over the caption templates' words), a
     2-item manifest of 1500-frame vocal mels, a DiT and a VAE ``.pt``; the
     T5 tower in fp32 on the card against the same tower on the CPU; 96 K1
     launches per (item, scale); every accompaniment wav 481,280 finite,
     non-silent samples at -23 +/- 0.5 LUFS; ``clap.csv`` with items x
     scales rows; host wall and device time per item, scale and stage;
 12. prints the kernel table as JSON, then ``{"ok": true, ...}`` last.
"""

from __future__ import annotations

import copy
import csv
import ctypes
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from versband_tpu_torch.cli.generate import build_vocoder
from versband_tpu_torch.models.autoencoder import AutoencoderKL
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.models.dit import BandMoeDiT
from versband_tpu_torch.ops import _build
from versband_tpu_torch.ops import flash_attention as fa
from versband_tpu_torch.ops import fused_act1d as fa1
from versband_tpu_torch.ops import fused_wavenet as fw
from versband_tpu_torch.sample.pipeline import PipelinedGenerator
from versband_tpu_torch.train.callbacks import Callback
from versband_tpu_torch.train.lr_schedules import scale_base_lr
from versband_tpu_torch.train.state import TrainState, make_adamw
from versband_tpu_torch.train.step import make_cfm_train_step
from versband_tpu_torch.train.trainer import CFMTrainer
from versband_tpu_torch.vocoder.bigvgan import BigVGANGenerator
from versband_tpu_torch.vocoder.hifigan import HifiGanGenerator
from versband_tpu_torch.vocoder.pwg import ParallelWaveGANGenerator, ResidualBlock

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
VOCODERS = ("hifigan", "bigvgan", "pwg")  # served in this order; hifigan in bf16
# the generators' defaults (BigVGANGenerator(), ParallelWaveGANGenerator())
BIGVGAN_CH0, BIGVGAN_RATES, BIGVGAN_ACTS_PER_STAGE = 512, (5, 4, 4, 4), 3 * 3 * 2
PWG_R, PWG_GATE, PWG_S, PWG_A, PWG_LAYERS, PWG_PER_STACK = 64, 128, 64, 80, 30, 10
K4_PER_CLIP = BIGVGAN_ACTS_PER_STAGE * len(BIGVGAN_RATES) + 1  # + activation_post
K5_PER_CLIP = PWG_LAYERS
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
# products are three TF32 passes over split operands (2^-21 of a term dropped)
# summed in another order over up to 768 rows or keys; bf16 kernels round P
# and dS to bf16 before the second products and each gradient to bf16 once
# (half an ulp is 2^-9 of a value, and the largest values set the scale).
K23_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# K4 against its plain version: fp32 as max|kernel - plain| / max(1, max|plain|)
# (the JAX test's 2e-5: FIRs in another order, sin^2 by a reduced polynomial
# within 2.3e-7); bf16 / max|plain|
# (fp32 math on both sides from the same bf16 input, output rounded once).
K4_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# K5 against its plain version, (x', skip') each over its max|plain|: fp32 1e-5
# (JAX's bar: sums of 3R + A = 272 and G = 64 terms in another order, as three
# TF32 passes over split operands, 2^-21 of a term dropped); bf16 x' 1e-2
# (rounded to bf16 once), skip' fp32 on both sides 1e-5.
K5_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-5)}
# fp32 modules on the card against the CPU (TF32 off): summation order over
# 768-1536-wide products through 4 blocks / ~30 conv layers.
MODULE_TOL = 2e-3
# The fp32 T5 tower on the card against the CPU, max|d| over hidden states of
# O(1) (after the final RMS norm): summation order over 1024- and 2816-wide
# products through 24 blocks, TF32 off.
T5_TOL = 2e-3

# [cli]: configs/vocal2music.yaml's cond_stage_config.params.version, relative
# to the CLI's working directory, and google/flan-t5-large's published
# config.json geometry
T5_DIR = Path("useful_ckpts") / "flan-t5-large"
FLAN_T5_LARGE = dict(model_type="t5", d_model=1024, d_ff=2816, d_kv=64, num_heads=16,
                     num_layers=24, feed_forward_proj="gated-gelu", vocab_size=32128,
                     relative_attention_num_buckets=32, relative_attention_max_distance=128,
                     layer_norm_epsilon=1e-6)
CLI_ITEMS, CLI_SCALES = 2, "1-2"
CLI_T_MEL = 1500  # 1500 x 320 / 24000 = 20.0 s, within --max_sec 20; padded to 1504
CLI_LUFS, CLI_LUFS_TOL = -23.0, 0.5
CLI_WORK = Path("build") / "chip_smoke_cli"
CLI_CONFIG = Path("configs") / "vocal2music.yaml"  # as committed
# One fp32 train step, card against CPU: the loss relative to itself, and
# for each parameter max|grad_card - grad_cpu| relative to that parameter's
# largest CPU gradient, or to STEP_GRAD_FLOOR x the largest of all where its
# own is smaller (summation order through the VAE encoder, 4 blocks forward
# and backward, K1-K3).
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_GRAD_FLOOR = 1e-4, 1e-3, 1e-3

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 FMA, TF32 tensor
# cores, HBM3.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
# An fp32-accurate matrix product can run as fp32 FMA or as three TF32
# tensor-core passes over split operands; the bound of an fp32 attention
# kernel takes the faster of the two, whatever the kernel itself does.
PEAK_FP32_PRODUCT = max(PEAK_FLOPS[torch.float32], PEAK_FLOPS["tf32"] / 3)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, over ``iters`` back-to-back calls.
    The stream is first held busy (~10 ms of ``torch.cuda._sleep``) while the
    host enqueues the calls, so a call whose wrapper costs the host more than
    its kernel costs the card (tens of microseconds) is still timed on the
    card, not on the host."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, dtype: torch.dtype = torch.float32,
             products: bool = False) -> tuple:
    """Least time of a function on this card: the larger of its FLOPs over
    the peak rate for ``dtype`` and its bytes over HBM; and what bounds it.
    ``products``: the FLOPs are matrix products, which in fp32 may also run
    as three TF32 passes (``PEAK_FP32_PRODUCT``)."""
    peak = PEAK_FP32_PRODUCT if products and dtype == torch.float32 else PEAK_FLOPS[dtype]
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound_ms(q, k, v, kv_len, products: bool = True) -> tuple:
    """K1's bound for these inputs: 4 FLOP per (query, valid key, dim); q, k,
    v read once, out and lse written once. ``products=False`` gives the fp32
    bound by FMA alone."""
    B, Tq, H, D = q.shape
    keys = k.shape[1] * B if kv_len is None else int(kv_len.clamp(0, k.shape[1]).sum())
    flops = 4 * H * Tq * keys * D
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size() + B * H * Tq * 4
    return bound_ms(flops, nbytes, q.dtype, products)


def bwd_bound_ms(q, k, kv_len, kernel: str, products: bool = True) -> tuple:
    """Least time of K2 ("dq": 6 FLOP per (query, valid key, dim)) or K3
    ("dkv": 8), with q, k, v, dO, lse and delta read once and the gradients
    written once. ``products=False`` gives the fp32 bound by FMA alone."""
    B, Tq, H, D = q.shape
    keys = k.shape[1] * B if kv_len is None else int(kv_len.clamp(0, k.shape[1]).sum())
    flops = (6 if kernel == "dq" else 8) * H * Tq * keys * D
    e = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * e + 2 * B * H * Tq * 4
    nbytes += q.numel() * e if kernel == "dq" else 2 * k.numel() * e
    return bound_ms(flops, nbytes, q.dtype, products)


def reset_launches() -> None:
    fa.LAUNCHES = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = fa1.LAUNCHES = fw.LAUNCHES = 0


def launches() -> tuple:
    """Launch counts of K1, K2, K3 (the training path's kernels)."""
    return fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV


def k4_serving_shapes() -> list:
    """((C, T), calls) of K4 per 20 s clip through ``BigVGANGenerator()``."""
    shapes, T = [], T_MEL
    for i, r in enumerate(BIGVGAN_RATES):
        T *= r
        last = i == len(BIGVGAN_RATES) - 1
        shapes.append(((BIGVGAN_CH0 // 2 ** (i + 1), T), BIGVGAN_ACTS_PER_STAGE + int(last)))
    return shapes


def k4_bound_ms(x) -> tuple:
    """K4's bound: 24 multiply-adds and 2 Snake evaluations (sin + 4 ops) per
    output element; x read once, out written once."""
    return bound_ms((2 * 24 + 2 * 5) * x.numel(), 2 * x.numel() * x.element_size(), x.dtype)


def k5_bound_ms(x, A: int, S: int, G: int, products: bool = True) -> tuple:
    """K5's bound: the gate conv and aux 1x1 (3R + A -> 2G), tanh and sigmoid,
    the skip and out 1x1s (G -> S + R) per sample; x, c, skip read once, x'
    and skip' written once. ``products=False`` gives the fp32 bound by FMA
    alone."""
    B, R, T = x.shape
    flops = (2 * (2 * G * (3 * R + A) + (S + R) * G) + 2 * G) * B * T
    nbytes = B * T * ((R + A + R) * x.element_size() + 2 * S * 4)
    return bound_ms(flops, nbytes, x.dtype, products)


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> dict:
    """Build the kernels (and, where ``build/parent`` holds an earlier tree,
    that tree's K4 and K5, all compilers started together); print registers,
    shared memory and spills; return the earlier tree's K4/K5 modules."""
    t0 = time.perf_counter()
    parent_jobs = start_parent_builds()
    libs = _build.build_all()
    parents = finish_parent_builds(parent_jobs)
    print(f"[build] {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(sorted(libs)) + (f"; from {PARENT}: " + ", ".join(sorted(parents))
                                       if parents else f"; no {PARENT}: no earlier K4/K5 timed"))
    spilled = []
    for name, path in libs.items():  # ptxas -v: registers and spills per kernel
        log = path.with_suffix(".log")
        entry, spills = "?", "?"
        for line in (log.read_text().splitlines() if log.exists() else []):
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                entry = m[1]
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                spills = f"{m[1]}/{m[2]} B"
                held = name.startswith("fused_") or (name.startswith("flash_attn")
                                                     and "Li96E" in entry)
                if held and int(m[1]) + int(m[2]):
                    spilled.append(entry)
            elif m := re.search(r"Used (\d+) registers(.*)", line):
                print(f"[build] {name}: {entry}: {m[1]} registers{m[2]}, spill stores/loads "
                      f"{spills}")
    if spilled:  # K4, K5 and the attention kernels at the shipped head dim: 0 spill bytes
        raise AssertionError(f"kernels spill: {spilled}")
    return parents


PARENT = Path("build") / "parent"  # an earlier tree, unpacked there to be compared with
PARENT_KERNELS = ("fused_act1d", "fused_wavenet")


def start_parent_builds() -> list:
    """Start one nvcc per K4/K5 source of the tree under ``PARENT`` (none
    without such a tree)."""
    csrc = PARENT / "versband_tpu_torch" / "ops" / "csrc"
    if not csrc.is_dir():
        return []
    return _build.start({name: csrc / f"{name}.cu" for name in PARENT_KERNELS},
                        Path("build") / "parent_kernels", include=csrc)


def finish_parent_builds(jobs: list) -> dict:
    """The earlier tree's K4/K5 wrapper modules, each loaded from that tree
    and bound to the library built from its own source."""
    mods = {}
    for name, (lib, _) in _build.finish(jobs).items():
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}", PARENT / "versband_tpu_torch" / "ops" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod._build = types.SimpleNamespace(load=lambda _name, so=ctypes.CDLL(str(lib)): so)
        mods[name] = mod
    return mods


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
        again = fa.flash_attention_fwd(q, k, v, kv_len, scale)
        s = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
        ref, ref_lse = fa._reference_fwd(q, k, v, kv_len, s)
        torch.cuda.synchronize()
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f"K1 is not bit-equal over two runs on {name}")
        err = (out.float() - ref.float()).abs().max().item()
        rows = slice(None) if lens is None else kv_len > 0  # a row with no key has no lse
        lse_err = (lse[rows] - ref_lse[rows]).abs().max().item()
        tol = K1_TOL[q.dtype]
        dt = str(q.dtype).replace("torch.", "")
        print(f"[k1] {name:11s} {dt:8s} q{tuple(q.shape)} k{tuple(k.shape)} "
              f"max|kernel-plain| out {err:.3e} (tol {tol:g}), lse {lse_err:.3e} "
              f"(tol {K1_LSE_TOL:g}), bit-equal over two runs")
        if not (err <= tol and lse_err <= K1_LSE_TOL and torch.isfinite(lse).all()):
            raise AssertionError(f"K1 disagrees with its plain version on {name} {dt}: "
                                 f"out {err}, lse {lse_err}")
        if lens is not None and (out[1] != 0).any():
            raise AssertionError("K1: kv_len == 0 row is not 0")
        errs[(name, q.dtype)] = err

    timing = {}
    shapes = (("serving", (2, T_LAT, T_LAT, 8, 96)),
              ("training", (TRAIN_B, T_TRAIN, T_TRAIN, 8, 96)))
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        for name, shape in shapes:
            q, k, v = qkv(*shape, dtype)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 100)
            plain = cuda_ms(lambda: fa.flash_attention_reference(q, k, v), 10)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 100)
            bound, by = k1_bound_ms(q, k, v, None)
            fma = ""
            if dtype == torch.float32:  # the bound before three-pass TF32 was counted
                fma = f"; bound by fp32 FMA alone {k1_bound_ms(q, k, v, None, False)[0]:.4f} ms"
            print(f"[k1] {name} {dt} q{tuple(q.shape)}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"scaled_dot_product_attention {lib:.4f} ms, bound {bound:.4f} ms ({by}), "
                  f"kernel at {bound / ms:.1%} of bound, {ms / lib:.2f}x the library's time{fma}")
            if bound / ms > 1.0:
                raise AssertionError(f"K1 {name} {dt}: the kernel beat its bound")
            timing[(name, dtype)] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                         bound_by=by)
    return {"max_abs_err": errs[("serving", torch.bfloat16)],
            **timing[("serving", torch.bfloat16)]}


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
            again = fa.flash_attention_bwd(q, k, v, kv_len, out, lse, dout, scale)
            ref = fa.flash_attention_bwd_reference(q, k, v, kv_len, out, lse, dout, scale)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K2/K3 are not bit-equal over two runs on {name} {dt}")
            row, rel = {}, 0.0
            for gname, a, b in zip(("dq", "dk", "dv"), got, ref):
                err = (a.float() - b.float()).abs().max().item()
                big = b.float().abs().max().item()
                tol = K23_TOL[dtype] * big
                row[gname] = err
                rel = max(rel, err / big) if big > 0 else math.inf
                if not (err <= tol and big > 0 and torch.isfinite(a).all()):
                    raise AssertionError(f"K2/K3 {gname} disagrees with the plain backward on "
                                         f"{name} {dt}: {err} > {tol}")
            if lens is not None and any((g[1] != 0).any() for g in got):
                raise AssertionError("K2/K3: a kv_len == 0 row has nonzero gradients")
            print(f"[k23] {name:11s} {dt:8s} q{tuple(q.shape)} k{tuple(k.shape)} "
                  f"max|kernel-plain| dq {row['dq']:.3e} dk {row['dk']:.3e} dv {row['dv']:.3e}"
                  f", worst {rel:.2e} x max|plain| (tol {K23_TOL[dtype]:g})")
            errs[(name, dtype)] = row

    timing = {}
    shapes = (("training", (TRAIN_B, T_TRAIN, T_TRAIN, 8, 96)),
              ("serving", (2, T_LAT, T_LAT, 8, 96)))
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).replace("torch.", "")
        for name, shape in shapes:
            q, k, v, dout = inputs(*shape, dtype)
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
            lib = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True),
                          20)
            bq, bq_by = bwd_bound_ms(q, k, None, "dq")
            bkv, bkv_by = bwd_bound_ms(q, k, None, "dkv")
            fma = ""
            if dtype == torch.float32:  # the bound before three-pass TF32 was counted
                fma = (f"; bounds by fp32 FMA alone K2 "
                       f"{bwd_bound_ms(q, k, None, 'dq', False)[0]:.4f} K3 "
                       f"{bwd_bound_ms(q, k, None, 'dkv', False)[0]:.4f} ms")
            print(f"[k23] {name} {dt}: K2 {dq_ms:.4f} ms (plain {plain_dq:.4f}, bound {bq:.4f} "
                  f"{bq_by}, {bq / dq_ms:.1%} of bound); K3 {dkv_ms:.4f} ms (plain "
                  f"{plain_dkv:.4f}, bound {bkv:.4f} {bkv_by}, {bkv / dkv_ms:.1%} of bound); "
                  f"delta {delta_ms:.4f} ms; K2+K3+delta {dq_ms + dkv_ms + delta_ms:.4f} ms "
                  f"against the scaled_dot_product_attention backward {lib:.4f} ms{fma}")
            if max(bq / dq_ms, bkv / dkv_ms) > 1.0:
                raise AssertionError(f"K2/K3 {name} {dt}: a kernel beat its bound")
            timing[(name, dtype)] = dict(
                dq=dict(ms=dq_ms, plain_ms=plain_dq, bound_ms=bq, bound_by=bq_by,
                        library_ms=lib),
                dkv=dict(ms=dkv_ms, plain_ms=plain_dkv, bound_ms=bkv, bound_by=bkv_by,
                         library_ms=lib))
    train_err = errs[("training", torch.float32)]
    t32 = timing[("training", torch.float32)]
    return {"dq": {"max_abs_err": train_err["dq"], **t32["dq"]},
            "dkv": {"max_abs_err": max(train_err["dk"], train_err["dv"]), **t32["dkv"]}}


def _snake_params(gen, C: int, dev, beta: bool, logscale: bool):
    """Per-channel alpha (and beta): around 0 before exp, or in [0.2, 1.2]."""
    draw = ((lambda: torch.randn(C, generator=gen, device=dev) * 0.3) if logscale
            else (lambda: torch.rand(C, generator=gen, device=dev) + 0.2))
    return draw(), (draw() if beta else None)


def phase_k4(dev, parent=None) -> dict:
    """K4 against its plain version; timed at the serving shapes (and the
    earlier tree's K4, ``parent``, on the same inputs where given)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    serving = k4_serving_shapes()
    cases = [(f"serving C{C}", 1, C, T, True, True) for (C, T), _ in serving]
    cases += [("snake", 1, 64, 4001, False, True), ("snake lin", 1, 64, 4001, False, False),
              ("snakebeta lin", 1, 64, 4001, True, False), ("B=2", 2, 32, 3001, True, True)]
    cases += [(f"T={T}", 2, 8, T, True, True) for T in (1, 5, 37)]
    cases.append(("strided", 2, 6, 1500, True, True))
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).replace("torch.", "")
        for name, B, C, T, beta, logscale in cases:
            x = torch.randn(B, C, T, generator=gen, device=dev).to(dtype)
            if name == "strided":  # a [B, C, T] view of a [B, T, C] tensor
                x = x.transpose(1, 2).contiguous().transpose(1, 2)
            alpha, b = _snake_params(gen, C, dev, beta, logscale)
            out = fa1.fused_alias_free_snake(x, alpha, b, logscale)
            ref = fa1.alias_free_snake_reference(x, alpha, b, logscale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            big = ref.float().abs().max().item()
            scale = max(1.0, big) if dtype == torch.float32 else big
            print(f"[k4] {name:13s} {dt:8s} x{tuple(x.shape)} max|kernel-plain| {err:.3e} "
                  f"(tol {K4_TOL[dtype]:g} x {scale:.3f})")
            if not (err <= K4_TOL[dtype] * scale and torch.isfinite(out).all()
                    and out.dtype == dtype):
                raise AssertionError(f"K4 disagrees with its plain version on {name} {dt}: {err}")
            errs[(name, dtype)] = err

    timing, clip_ms, parent_clip_ms = {}, 0.0, 0.0
    for (C, T), calls in serving:
        x = torch.randn(1, C, T, generator=gen, device=dev)
        alpha, b = _snake_params(gen, C, dev, True, True)
        ms = cuda_ms(lambda: fa1.fused_alias_free_snake(x, alpha, b), 50)
        plain = cuda_ms(lambda: fa1.alias_free_snake_reference(x, alpha, b), 10)
        bound, by = k4_bound_ms(x)
        clip_ms += calls * ms
        earlier = ""
        if parent is not None:
            pms = cuda_ms(lambda: parent.fused_alias_free_snake(x, alpha, b), 50)
            parent_clip_ms += calls * pms
            perr = (parent.fused_alias_free_snake(x, alpha, b)
                    - fa1.fused_alias_free_snake(x, alpha, b)).abs().max().item()
            earlier = f"; {PARENT}'s K4 {pms:.4f} ms (max|d| {perr:.2e} from this one)"
        print(f"[k4] serving float32 x[1, {C}, {T}] ({calls} per clip): kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bound:.4f} ms ({by}), kernel at {bound / ms:.1%} "
              f"of bound{earlier}")
        if bound / ms > 1.0:
            raise AssertionError(f"K4 at [1, {C}, {T}]: the kernel beat its bound")
        timing[(C, T)] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)
    print(f"[k4] {K4_PER_CLIP} launches per clip: {clip_ms:.4f} ms of kernel time"
          + (f" ({PARENT}'s K4: {parent_clip_ms:.4f} ms)" if parent is not None else ""))
    (C, T), _ = serving[-1]
    return {"max_abs_err": errs[(f"serving C{C}", torch.float32)], **timing[(C, T)],
            "library_ms": None}


def _k5_weights(dev, R: int, G2: int, S: int, A: int, d: int, seed: int):
    torch.manual_seed(seed)
    blk = ResidualBlock(3, R, G2, S, A, d).to(dev)
    return (blk.conv.weight, blk.conv.bias, blk.conv1x1_aux.weight, blk.conv1x1_skip.weight,
            blk.conv1x1_skip.bias, blk.conv1x1_out.weight, blk.conv1x1_out.bias)


def _k5_inputs(gen, dev, B: int, T: int, R: int, A: int, S: int, dtype):
    return (torch.randn(B, R, T, generator=gen, device=dev).to(dtype),
            torch.randn(B, A, T, generator=gen, device=dev).to(dtype),
            torch.randn(B, S, T, generator=gen, device=dev))


@torch.no_grad()
def phase_k5(dev, parent=None) -> dict:
    """K5 against its plain version, bit-equal over two runs; timed per
    layer with its weights packed once (and the earlier tree's K5,
    ``parent``, on the same inputs where given)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    R, G2, S, A = PWG_R, PWG_GATE, PWG_S, PWG_A
    T = T_MEL * HOP
    dilations = [2 ** i for i in range(PWG_PER_STACK)]
    cases = [("serving", 1, T, d, torch.float32) for d in dilations]
    cases.append(("serving", 1, T, 1, torch.bfloat16))
    for dtype in (torch.float32, torch.bfloat16):
        cases += [("B=2 ragged", 2, 3001, 4, dtype), ("B=2 T<2d", 2, 700, 512, dtype)]
    errs = {}
    for name, B, t, d, dtype in cases:
        dt = str(dtype).replace("torch.", "")
        w = _k5_weights(dev, R, G2, S, A, d, SEED + d)
        x, c, skip = _k5_inputs(gen, dev, B, t, R, A, S, dtype)
        cache = fw.PackCache()  # the second call takes the weights packed by the first
        got = fw.fused_wavenet_layer(x, c, skip, *w, d, cache)
        again = fw.fused_wavenet_layer(x, c, skip, *w, d, cache)
        ref = fw.wavenet_layer_reference(x, c, skip, *w, d)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K5 is not bit-equal over two runs on {name} d={d} {dt}")
        row, rel = [], []
        for a, r, tol in zip(got, ref, K5_TOL[dtype]):
            err, big = (a.float() - r.float()).abs().max().item(), r.float().abs().max().item()
            row.append(err)
            rel.append(err / big)
            if not (err <= tol * big and torch.isfinite(a).all()):
                raise AssertionError(f"K5 disagrees with its plain version on {name} d={d} "
                                     f"{dt}: {err} > {tol} x {big}")
        print(f"[k5] {name:10s} {dt:8s} x[{B}, {R}, {t}] d={d:3d}: max|kernel-plain| x' "
              f"{row[0]:.3e} skip' {row[1]:.3e} ({rel[0]:.2e} / {rel[1]:.2e} x max|plain|, "
              f"tol {K5_TOL[dtype][0]:g} / {K5_TOL[dtype][1]:g}), bit-equal over two runs")
        errs[(name, d, dtype)] = max(row)

    print(f"[k5] shared memory per block: {fw.smem_bytes(R, A, torch.float32)} B fp32, "
          f"{fw.smem_bytes(R, A, torch.bfloat16)} B bf16 (R {R}, A {A}; one block per SM)")
    timing = {}
    x, c, skip = _k5_inputs(gen, dev, 1, T, R, A, S, torch.float32)
    for d in (1, dilations[-1]):
        w = _k5_weights(dev, R, G2, S, A, d, SEED + d)
        cache = fw.PackCache()  # packed once, as a ResidualBlock keeps them
        ref = fw.wavenet_layer_reference(x, c, skip, *w, d)
        for a, r, tol in zip(fw.fused_wavenet_layer(x, c, skip, *w, d, cache), ref,
                             K5_TOL[torch.float32]):  # the timed call, checked
            if not (a - r).abs().max().item() <= tol * r.abs().max().item():
                raise AssertionError(f"K5 d={d}: the timed call disagrees with the plain version")
        ms = cuda_ms(lambda: fw.fused_wavenet_layer(x, c, skip, *w, d, cache), 20)
        plain = cuda_ms(lambda: fw.wavenet_layer_reference(x, c, skip, *w, d), 5)
        bound, by = k5_bound_ms(x, A, S, G2 // 2)
        fma = k5_bound_ms(x, A, S, G2 // 2, products=False)[0]
        earlier = ""
        if parent is not None:
            pms = cuda_ms(lambda: parent.fused_wavenet_layer(x, c, skip, *w, d), 20)
            packed = parent.pack_weights(*w)
            pack_every_call = parent.pack_weights
            parent.pack_weights = lambda *_w: packed
            try:
                kernel_alone = cuda_ms(lambda: parent.fused_wavenet_layer(x, c, skip, *w, d), 20)
            finally:
                parent.pack_weights = pack_every_call
            earlier = (f"; {PARENT}'s K5 {pms:.4f} ms with its packing every call, "
                       f"{kernel_alone:.4f} ms packed once")
        print(f"[k5] serving float32 x[1, {R}, {T}] d={d}: kernel {ms:.4f} ms "
              f"(weights packed once), plain {plain:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"three-pass TF32) [fp32 FMA alone {fma:.4f}], kernel at {bound / ms:.1%} of "
              f"bound [{fma / ms:.1%}]; {K5_PER_CLIP} layers per clip {K5_PER_CLIP * ms:.2f} ms"
              + earlier)
        if bound / ms > 1.0:
            raise AssertionError(f"K5 d={d}: the kernel beat its bound")
        timing[d] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)
    return {"max_abs_err": errs[("serving", 1, torch.float32)], **timing[1], "library_ms": None}


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

    # BigVGAN and PWG at full width, fp32: card (K4 / K5) against CPU (plain)
    mel = torch.from_numpy(rng.randn(1, 80, 48).astype(np.float32))
    noise = torch.from_numpy(rng.randn(1, 1, 44 * HOP).astype(np.float32))  # 48 - 2 x 2 frames
    torch.manual_seed(SEED + 2)
    big = BigVGANGenerator().eval()
    pwg = ParallelWaveGANGenerator(fused_inference=True).eval()
    for name, model, args, counter, want in (
            ("BigVGAN", big, (mel,), fa1, K4_PER_CLIP),
            ("ParallelWaveGAN", pwg, (noise, mel), fw, K5_PER_CLIP)):
        ref = model(*args)
        model.to(dev)
        n = counter.LAUNCHES
        out = model(*(a.to(dev) for a in args))
        torch.cuda.synchronize()
        n = counter.LAUNCHES - n
        err = _max_diff(out, ref)
        print(f"[modules] {name} fp32 {tuple(ref.shape)} card ({n} launches of "
              f"{'K4' if counter is fa1 else 'K5'}) vs CPU (plain): max|d| {err:.3e} "
              f"(tol {MODULE_TOL:g}), |out|max {ref.abs().max():.3f}")
        if not (err <= MODULE_TOL and n == want and ref.abs().max() > 0):
            raise AssertionError(f"{name} on the card: max|d| {err}, {n} launches (want {want})")


def build_serving(dev, n_requests: int = N_REQUESTS):
    """The shipped-width serving models in bf16 (random weights from SEED),
    the unconditional branch, and ``n_requests`` (cond, generator) requests."""
    torch.manual_seed(SEED)
    cfm = CFM(unet_config=dict(target="versband_tpu.models.dit.BandMoeDiT", params=DIT),
              first_stage_config=dict(target="versband_tpu.models.autoencoder.AutoencoderKL",
                                      params=VAE),
              mel_dim=20, scale_factor=1.0, device=dev, dtype=DTYPE)
    perturb_zero_init(cfm.model, SEED)
    voc = build_vocoder("hifigan", device=dev, dtype=DTYPE)  # seed 0 = SEED

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


def serve_family(family: str, cfm, voc, uncond, requests) -> dict:
    """Serve ``requests`` through ``PipelinedGenerator`` with vocoder ``voc``;
    check the waveforms and the launches per clip; print the per-clip times."""
    events, counts = [], []
    want_k4 = K4_PER_CLIP if family == "bigvgan" else 0
    want_k5 = K5_PER_CLIP if family == "pwg" else 0

    def sample_fn(cond, generator):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        events.append(ev)
        n0 = fa.LAUNCHES
        ev[0].record()
        z = cfm.sample_cfg(cond, CFG_SCALE, uncond, generator, timesteps=STEPS)
        ev[1].record()
        counts.append([fa.LAUNCHES - n0])
        return z

    def decode_fn(z):
        mel = cfm.decode_first_stage(z)
        events[-1][2].record()
        return mel

    def vocode_fn(mel):
        n4, n5 = fa1.LAUNCHES, fw.LAUNCHES
        wav = voc.waveform(mel)[0]
        events[-1][3].record()
        counts[-1] += [fa1.LAUNCHES - n4, fw.LAUNCHES - n5]
        return wav

    pipe = PipelinedGenerator(sample_fn, decode_fn, vocode_fn, depth=2)
    torch.cuda.synchronize()
    reset_launches()  # count only the main path's launches
    t0 = time.perf_counter()
    with torch.inference_mode():
        wavs = list(pipe.generate(requests))
    wall = time.perf_counter() - t0
    main = {"k1": fa.LAUNCHES, "k4": fa1.LAUNCHES, "k5": fw.LAUNCHES}

    n = T_MEL * HOP
    for i, w in enumerate(wavs):
        if w.shape != (n,) or not np.isfinite(w).all() or not w.std() > 0:
            raise AssertionError(f"{family} request {i}: waveform shape {w.shape}, "
                                 f"finite {np.isfinite(w).all()}, std {w.std()}")
    want = [LAUNCHES_PER_CLIP, want_k4, want_k5]
    if counts != [want] * len(requests) or [main["k1"], main["k4"], main["k5"]] != \
            [sum(c[j] for c in counts) for j in range(3)]:
        raise AssertionError(f"{family}: K1/K4/K5 launches per request {counts}, total {main}; "
                             f"expected {want} each")
    audio_s = n / SR
    rows = []
    for i, ev in enumerate(events):
        r = dict(sample=ev[0].elapsed_time(ev[1]), decode=ev[1].elapsed_time(ev[2]),
                 vocode=ev[2].elapsed_time(ev[3]), total=ev[0].elapsed_time(ev[3]))
        rows.append(r)
        print(f"[serve] {family} request {i}: waveform [{n}] finite, K1/K4/K5 launches "
              f"{counts[i]}; " + ", ".join(f"{k} {v:.2f} ms" for k, v in r.items()))
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    print(f"[serve] per clip ({family}, median of {len(rows)}, device time): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items())
          + f"; rtf {audio_s / (med['total'] / 1e3):.2f}x for {audio_s:.3f} s of audio; "
          f"vocoder rtf {audio_s / (med['vocode'] / 1e3):.2f}x")
    print(f"[serve] {family}: host wall for {len(rows)} pipelined requests {wall * 1e3:.1f} ms "
          f"({audio_s * len(rows) / wall:.2f}x real time)")
    return main


def phase_serve(dev, families=VOCODERS) -> dict:
    """Serve the requests once per vocoder family, HiFi-GAN (bf16, the
    serving dtype) first; the other two as ``build_vocoder`` builds them
    (fp32)."""
    cfm, voc, uncond, requests = build_serving(dev)
    served = {}
    for family in families:
        if family != "hifigan":
            voc = build_vocoder(family, device=dev)
        served[family] = serve_family(family, cfm, voc, uncond, requests)
    return served


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


def write_tokenizer_json(path: Path, words) -> None:
    """A T5-style Unigram ``tokenizer.json`` written by hand: <pad> 0, </s> 1,
    <unk> 2, then one piece per character seen (score -5) and one per
    ``"▁" + word`` (score -1); ' {2,}' -> ' ', WhitespaceSplit + Metaspace,
    and ``$A </s>``."""
    words = sorted({w for w in words if w})
    chars = sorted({c for w in words for c in w} | set("0123456789.,:;!?'-"))
    vocab = [["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0], ["▁", -2.0]]
    vocab += [[c, -5.0] for c in chars] + [["▁" + w, -1.0] for w in words]
    special = [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
                "normalized": False, "special": True}
               for i, t in enumerate(("<pad>", "</s>", "<unk>"))]
    doc = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": special,
           "normalizer": {"type": "Sequence", "normalizers": [
               {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
           "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
               {"type": "WhitespaceSplit"},
               {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                "split": True}]},
           "post_processor": {"type": "TemplateProcessing",
                              "single": [{"Sequence": {"id": "A", "type_id": 0}},
                                         {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                              "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                              "special_tokens": {"</s>": {"id": "</s>", "ids": [1],
                                                          "tokens": ["</s>"]}}},
           "decoder": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                       "split": True},
           "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab, "byte_fallback": False}}
    path.write_text(json.dumps(doc, ensure_ascii=False))


def caption_words() -> list:
    """The words of the caption templates the CLI draws from, and of its
    'Style: ... Musical: ...' frame."""
    from versband_tpu_torch.text.caption_generator import reference_banks

    text = json.dumps(reference_banks()) + " Style: Musical: piano pop rock ballad soft"
    return re.findall(r"[A-Za-z]+|[0-9]+", text)


def write_t5_dir(path: Path, config: dict, seed: int) -> "T5Encoder":
    """A Hugging Face T5 checkpoint directory: ``config.json``, random
    weights (transformers' init, from ``seed``) as ``model.safetensors``,
    and a ``tokenizer.json`` over :func:`caption_words`."""
    from versband_tpu_torch.text.t5 import T5Encoder
    from versband_tpu_torch.utils.safetensors_io import save_safetensors

    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config))
    enc = T5Encoder(config).init_weights(torch.Generator().manual_seed(seed))
    save_safetensors(enc.state_dict(), str(path / "model.safetensors"), {"format": "pt"})
    write_tokenizer_json(path / "tokenizer.json", caption_words())
    return enc


def write_cli_inputs(root: Path, n_items: int, t_mel: int, dit: dict, vae: dict,
                     seed: int) -> dict:
    """The CLI's inputs under ``root``: a manifest of ``n_items`` vocal mels of
    ``t_mel`` frames (20.0 s each at 1500), ``midi.npy``/``beats.npy``, a DiT
    (adaLN-zero layers perturbed) and a VAE as ``.pt`` state dicts, and a
    HiFi-GAN directory (default geometry) with a ``model_gen.pt``. HiFi-GAN's
    own init (N(0, 0.01)) renders a near-silent click whose peak the -23 LUFS
    gain would push past full scale, where the limiter leaves it below -23;
    these weights are N(0, 1/fan_in) instead, and render noise-like audio."""
    rng = np.random.default_rng(seed)
    (root / "manifest").mkdir(parents=True, exist_ok=True)
    cols = ["name", "caption", "duration", "key", "key_confidence", "avg_pitch", "tempo",
            "tempo_confidence", "wav_len", "audio_path", "vocal_mel_path"]
    midi, beats, rows = {}, {}, []
    for i in range(n_items):
        name = f"song{i}"
        mel = root / f"{name}_vocal_mel.npy"
        np.save(mel, (rng.standard_normal((80, t_mel)) - 2.0).astype(np.float32))
        midi[name] = rng.integers(40, 90, t_mel)
        beats[name] = rng.integers(0, 2, t_mel)
        sec = t_mel * HOP / SR
        rows.append([name, "piano<psep>soft piano pop ballad", sec, "C major", 0.9,
                     60.0 + 5 * i, 96.0 + 20 * i, 0.8, sec, "", str(mel)])
    with open(root / "manifest" / "music.tsv", "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(cols)
        w.writerows(rows)
    np.save(root / "midi.npy", midi, allow_pickle=True)
    np.save(root / "beats.npy", beats, allow_pickle=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = BandMoeDiT(**dit)
        perturb_zero_init(model, seed)
        torch.save(model.state_dict(), root / "dit.pt")
        torch.save(AutoencoderKL(**vae).state_dict(), root / "vae.pt")
        voc = HifiGanGenerator()
    g = torch.Generator().manual_seed(seed)
    sd = {k: (torch.randn(v.shape, generator=g) / math.sqrt(v.shape[1] * v.shape[2])
              if v.ndim == 3 else v) for k, v in voc.state_dict().items()}
    (root / "hifigan").mkdir(exist_ok=True)
    torch.save(sd, root / "hifigan" / "model_gen.pt")
    return dict(manifest=str(root / "manifest"), midi=str(root / "midi.npy"),
                dit=str(root / "dit.pt"), vae=str(root / "vae.pt"),
                vocoder=str(root / "hifigan"))


def phase_cli(dev) -> int:
    """The inference CLI on the shipped YAML (phase 11); returns its K1 launches."""
    from versband_tpu_torch.cli import generate as cli
    from versband_tpu_torch.dsp.loudness import integrated_loudness
    from versband_tpu_torch.text.embedders import TextVocalEmbedder

    config = CLI_CONFIG.resolve()
    shutil.rmtree(CLI_WORK, ignore_errors=True)
    root = CLI_WORK.resolve()
    t0 = time.perf_counter()
    write_t5_dir(root / T5_DIR, FLAN_T5_LARGE, SEED)
    inputs = write_cli_inputs(root, CLI_ITEMS, CLI_T_MEL, DIT, VAE, SEED)
    print(f"[cli] inputs written in {time.perf_counter() - t0:.1f} s: {root / T5_DIR} "
          f"(flan-t5-large geometry, {(root / T5_DIR / 'model.safetensors').stat().st_size / 2**30:.2f}"
          f" GiB safetensors), {CLI_ITEMS} items of {CLI_T_MEL} frames")
    argv = ["--config", str(config), "--ckpt", inputs["dit"], "--vae_ckpt", inputs["vae"],
            "--vocoder_ckpt", inputs["vocoder"], "--manifest", inputs["manifest"], "--other_condition", inputs["midi"],
            "--scales", CLI_SCALES, "--num_items", str(CLI_ITEMS), "--seed", str(SEED),
            "--save_dir", "out"]
    cwd = os.getcwd()
    stats = []
    try:
        os.chdir(root)  # the YAML's relative version: resolves here
        torch.cuda.synchronize()
        reset_launches()  # count only this path's launches
        t0 = time.perf_counter()
        rc = cli.main(argv, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k4, k5 = fa.LAUNCHES, fa1.LAUNCHES, fw.LAUNCHES
        with open(root / "out" / "clap.csv", newline="") as f:
            rows = list(csv.DictReader(f, delimiter="\t"))
        wavs = sorted((root / "out").rglob("*.wav"))
        captions = [r["caption"] for r in rows]
        cpu = TextVocalEmbedder(version=str(T5_DIR), max_length=80, device="cpu")
        gpu = TextVocalEmbedder(version=str(T5_DIR), max_length=80, device=dev)
    finally:
        os.chdir(cwd)
    n_runs = CLI_ITEMS * len(CLI_SCALES.split("-"))
    print(f"[cli] main() returned {rc} in {wall:.2f} s host wall ({wall / CLI_ITEMS:.2f} s per "
          f"item, model build and checkpoint loads included); K1 launches {k1} "
          f"(want {LAUNCHES_PER_CLIP} x {n_runs}), K4 {k4}, K5 {k5}")
    if rc != 0 or k1 != LAUNCHES_PER_CLIP * n_runs or k4 or k5:
        raise AssertionError(f"[cli] rc {rc}, launches K1 {k1}, K4 {k4}, K5 {k5}")
    for r in stats:
        print(f"[cli] item {r['item']} scale {r['scale']}: " + ", ".join(
            f"{st} {r[st + '_ms']:.2f} ms host wall, {r[st + '_device_ms']:.2f} ms device"
            for st in cli.STAGES if st + "_ms" in r))
    for st in cli.STAGES:
        runs = [r for r in stats if st + "_ms" in r]
        print(f"[cli] stage {st}: median over {len(runs)} runs "
              f"{statistics.median(r[st + '_ms'] for r in runs):.2f} ms host wall, "
              f"{statistics.median(r[st + '_device_ms'] for r in runs):.2f} ms device")

    if len(rows) != n_runs or len(wavs) != n_runs:
        raise AssertionError(f"[cli] clap.csv has {len(rows)} rows and {len(wavs)} wavs, "
                             f"want {n_runs}")
    from scipy.io import wavfile

    n = (CLI_T_MEL + 7) // 8 * 8 * HOP
    for path in wavs:
        sr, pcm = wavfile.read(path)
        wav = pcm.astype(np.float32) / 32768.0
        lufs = integrated_loudness(wav, sr)
        print(f"[cli] {path.relative_to(root)}: {wav.shape[0]} samples at {sr} Hz, "
              f"finite {np.isfinite(wav).all()}, std {wav.std():.4f}, {lufs:.3f} LUFS")
        if not (sr == SR and wav.shape == (n,) and np.isfinite(wav).all() and wav.std() > 0
                and abs(lufs - CLI_LUFS) <= CLI_LUFS_TOL):
            raise AssertionError(f"[cli] {path}: {wav.shape} samples, {lufs} LUFS")

    with torch.inference_mode():
        texts = captions[:1] + [""]
        ref = cpu({"caption": texts, "acoustic": {}})["caption"]
        out = gpu({"caption": texts, "acoustic": {}})["caption"]
        torch.cuda.synchronize()
        t5_ms = cuda_ms(lambda: gpu({"caption": texts, "acoustic": {}}), 5, warmup=1)
    err = _max_diff(out, ref)
    print(f"[cli] T5 tower fp32 {tuple(ref.shape)} ({FLAN_T5_LARGE['num_layers']} blocks, "
          f"d_model {FLAN_T5_LARGE['d_model']}) card vs CPU: "
          f"max|d| {err:.3e} (tol {T5_TOL:g}), |out|max {ref.abs().max():.3f}; card "
          f"{t5_ms:.2f} ms per call of 2 captions (tokenizer included)")
    if not err <= T5_TOL:
        raise AssertionError(f"T5 on the card disagrees with the CPU: {err}")
    del cpu, gpu
    shutil.rmtree(CLI_WORK, ignore_errors=True)
    return k1


def main() -> None:
    smi = phase_card()
    dev = torch.device("cuda")
    parents = phase_build()
    k1 = phase_k1(dev)
    k23 = phase_k23(dev)
    k4 = phase_k4(dev, parents.get("fused_act1d"))
    k5 = phase_k5(dev, parents.get("fused_wavenet"))
    phase_modules(dev)
    served = phase_serve(dev)
    trained = phase_train(dev)
    phase_grad_parity(dev)
    n_cli = phase_cli(dev)
    n_train = trained["launches"]
    n_serve = {k: sum(f[k] for f in served.values()) for k in ("k1", "k4", "k5")}
    bwd_src = "versband_tpu_torch/ops/csrc/flash_attn_bwd.cu"
    table = [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "versband_tpu_torch/ops/csrc/flash_attn_fwd.cu",
         "replaces": "versband_tpu/ops/flash_attention.py:57",
         "launches": n_serve["k1"] + n_train[0] + n_cli, **k1},
        {"name": "flash_attn_bwd_dq", "route": "cuda", "source": bwd_src,
         "replaces": "versband_tpu/ops/flash_attention.py:162", "launches": n_train[1],
         **k23["dq"]},
        {"name": "flash_attn_bwd_dkv", "route": "cuda", "source": bwd_src,
         "replaces": "versband_tpu/ops/flash_attention.py:196", "launches": n_train[2],
         **k23["dkv"]},
        {"name": "fused_alias_free_snake", "route": "cuda",
         "source": "versband_tpu_torch/ops/csrc/fused_act1d.cu",
         "replaces": "versband_tpu/ops/fused_act1d.py:94", "launches": n_serve["k4"], **k4},
        {"name": "fused_wavenet_layer", "route": "cuda",
         "source": "versband_tpu_torch/ops/csrc/fused_wavenet.cu",
         "replaces": "versband_tpu/ops/fused_wavenet.py:46", "launches": n_serve["k5"], **k5},
    ]
    if not all(k["launches"] > 0 for k in table):
        raise AssertionError(f"a kernel did not run on the main path: "
                             f"{[(k['name'], k['launches']) for k in table]}")
    print(f"kernels: {[k['name'] for k in table]}; K1 launches: serving {n_serve['k1']}, "
          f"training {n_train[0]}, cli {n_cli}; K4 {n_serve['k4']} (bigvgan), "
          f"K5 {n_serve['k5']} (pwg)")
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
