#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Drives the port's serving path -- Band-MoE DiT inside the CFG Euler sampler,
VAE decode, HiFi-GAN -- at the shipped widths of configs/vocal2music.yaml
(random weights from a seed), through ``PipelinedGenerator``, and holds every
CUDA kernel of that path against its plain PyTorch version on the card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the card: requires CUDA; prints ``nvidia-smi`` name and power limit;
  2. builds the kernels from ``versband_tpu_torch/ops/csrc`` (nvcc, sm_90a);
  3. K1 (flash-attention forward) against its plain version at the serving
     shape and on ragged, masked and scaled cases; times kernel, plain
     version and ``F.scaled_dot_product_attention`` (a yardstick only);
  4. the shipped-width DiT forward (fp32) on the card against the CPU, and
     the VAE decoder and HiFi-GAN likewise at a short length;
  5. serves 3 requests (20 s clips, bf16, CFG 2.0, 25 steps) and checks the
     waveforms and that every DiT self-attention went through K1;
  6. prints the kernel table as JSON, then ``{"ok": true, ...}`` last.
"""

from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from versband_tpu_torch.models.autoencoder import AutoencoderKL
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.models.dit import BandMoeDiT
from versband_tpu_torch.ops import _build
from versband_tpu_torch.ops import flash_attention as fa
from versband_tpu_torch.sample.pipeline import PipelinedGenerator
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

# K1 against its plain version: fp32 differs by summation order only; bf16
# rounds the probabilities and the output (outputs are O(1)).
K1_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# fp32 modules on the card against the CPU (TF32 off): summation order over
# 768-1536-wide products through 4 blocks / ~30 conv layers.
MODULE_TOL = 2e-3

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


def k1_bound_ms(q, k, v, kv_len) -> tuple:
    """Least time for the work these inputs need: the larger of FLOPs over the
    peak rate and bytes (q, k, v read once; out, lse written once) over HBM."""
    B, Tq, H, D = q.shape
    keys = k.shape[1] * B if kv_len is None else int(kv_len.clamp(0, k.shape[1]).sum())
    flops = 4 * H * Tq * keys * D
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size() + B * H * Tq * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
                  ("tq!=tk d64", qkv(2, 300, 517, 4, 64, dtype), None, None),
                  ("varlen+0", qkv(3, 200, T_LAT, 8, 96, dtype), [T_LAT, 0, 301], None),
                  ("scale d128", qkv(2, 129, 250, 2, 128, dtype), None, 0.3)]
    errs = {}
    for name, (q, k, v), lens, scale in cases:
        kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
        out, lse = fa.flash_attention_fwd(q, k, v, kv_len, scale)
        ref = fa.flash_attention_reference(q, k, v, kv_len, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = K1_TOL[q.dtype]
        dt = str(q.dtype).replace("torch.", "")
        print(f"[k1] {name:11s} {dt:8s} q{tuple(q.shape)} k{tuple(k.shape)} "
              f"max|kernel-plain| {err:.3e} (tol {tol:g})")
        if not (err <= tol and torch.isfinite(lse).all()):
            raise AssertionError(f"K1 disagrees with its plain version on {name} {dt}: {err}")
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
    return {"max_abs_err": errs[("serving", torch.bfloat16)], **timing[torch.bfloat16]}


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


def main() -> None:
    smi = phase_card()
    dev = torch.device("cuda")
    phase_build()
    k1 = phase_k1(dev)
    phase_modules(dev)
    served = phase_serve(dev)
    print('kernels: ["flash_attn_fwd"]')
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "versband_tpu_torch/ops/csrc/flash_attn_fwd.cu",
        "replaces": "versband_tpu/ops/flash_attention.py:57",
        "launches": served["launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
