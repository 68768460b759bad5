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
  ``CFMTrainer.fit``, and through the training CLI from a manifest;
* the CLIs -- ``cli.generate`` and ``cli.train`` on ``configs/vocal2music.yaml``
  as committed, and ``cli.train`` on ``configs/ae_accomp.yaml`` (stage 1, the
  VAE-GAN, with K4 in its BigVGAN audio logger);
* the vocoders' GAN recipes -- HiFi-GAN (MPD + MSD), BigVGAN (MPD + MRD) and
  ParallelWaveGAN (MR-STFT, RAdam) at full width, each trained generator then
  served through ``build_vocoder`` with K4 (BigVGAN) or K5 (PWG) live;
* data preparation -- ``make_manifest``, ``mel_extract`` (the mel on the card)
  and ``postprocess`` on synthetic songs, then training from their output;
* data-parallel training -- ``cli.train`` under the torchrun environment over
  NCCL at world size 1, in this process and through ``torch.distributed.run``;
* tensor and expert parallelism -- the CFM step at full width on 4 ranks
  that share the card over gloo, against the one-process step; the same for
  the legacy backbones (the Time/Freq-MoE DiT cut over heads and frequency
  experts, through ``cli.train --n_model``; a ConcatDiT kept whole);
* AudioLDM's best-of-N generation -- the classic samplers (DDIM, PLMS, the
  ancestral loop) over the shipped DiT, decode, HiFi-GAN and the CLAP rerank
  (Cnn14 and a BERT caption tower at their published geometry);
* the legacy backbones at their published widths -- the Time/Freq-MoE DiT
  served through ``cli.generate`` with BigVGAN (K4 live), the order-
  conditioned LDM over ``ConcatOrderDiT`` with DDIM, the 2-D KL first stage,
  and every new module card against CPU at a small width.

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
     the VAE decoder, HiFi-GAN, BigVGAN (73 K4), PWG (30 K5) and HiFi-GAN
     NSF (f0 estimated from the mel, the source's draws injected) likewise at
     a short length;
  8. serves 3 requests (20 s clips, bf16 sampler and decoder, CFG 2.0, 25
     steps) once per vocoder family (hifigan, bigvgan, pwg, nsf) and checks
     the waveforms and the launches per clip: 96 K1, and 73 K4 (bigvgan) or
     30 K5 (pwg); [nsf]: ``NSFHifiGanGenerator()``'s defaults from a
     ``model_ckpt_steps_1.ckpt``, f0 estimated from each mel, every clip
     481,280 finite samples at -23 +/- 0.5 LUFS after normalisation;
 8b. [bf16-serve] bf16 serving against fp32 serving on the card (TF32 off),
     on the same weights made on the CPU from SEED (shipped-width DiT, VAE,
     HiFi-GAN in fp32, its conv weights N(0, 1/fan_in); the bf16 models cast
     as the serving path casts them)
     and the same request and bf16 start noise: the relative L2 gap of the
     latent (sampler from the start noise, 96 K1 launches in the bf16 run),
     the mel (decode of the fp32 latent rounded to bf16) and the waveform
     (vocode of the fp32 mel rounded to bf16), each stage fed one input in
     both dtypes, and end to end; each must stay under 1.5x the JAX
     package's own bf16-against-fp32 gap for that stage at this width
     (``BF16_JAX_GAPS``), and the end-to-end gap must exceed the waveform
     stage's 1.2-fold (the waveform follows the mel);
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
 12. [train-cli] the training CLI, ``versband_tpu_torch.cli.train.main``, in
     this process on the card with ``configs/vocal2music.yaml`` as committed
     and only path and run-length overrides, from the same scratch directory
     (the T5 directory of phase 11, a HiFi-GAN at ``useful_ckpts/hifigan``
     for ``AudioLogger``): a manifest of 316 rows (300 validation, 16 train;
     8 distinct mel and vocal-mel files of [80, 1800], so the 1500-frame crop
     runs) with ``midi.npy``/``beats.npy``, the VAE ``.pt`` of phase 11 as
     ``first_stage_config.params.ckpt_path``. Run 1 trains 4 steps (2 epochs
     of 2 batches of 8, ``--steps_per_call 2``, prefetch on), validates after
     each epoch and logs images and audio every 2 steps; checks
     ``last.pt``/``last_step.json`` (step 4, a scale_factor other than 1),
     the archived ``<now>-project.yaml`` read back equal, finite
     ``val/loss_simple``, the PNG and WAV logs, the first stage loaded from
     its checkpoint, K1/K2/K3 launches of 4/4/4 per train step, 4 K1 per
     validation batch and 96 per ``log_images``, the caption tower's output
     on the card and no K1 in it. Run 1 again with ``--prefetch_groups 0``;
     run 2 resumes with ``-r`` and ends at step 6; ``cli.generate`` then
     serves one item at ``--scales 1`` from the archived config and that
     checkpoint: 481,280 finite samples at -23 +/- 0.5 LUFS. Prints per run
     the event time per step, host wall per step, steps/s, the tower's time
     per group, validation's wall and peak memory;
 13. [vae-train-cli] the training CLI on ``configs/ae_accomp.yaml`` as
     committed (batch 20, 624-frame crops padded to 640, the full-width
     VAE and PatchGAN), with path and run-length overrides and
     ``disc_start`` lowered to 2 so both sides of the gate run: a manifest
     of 140 rows (100 held out) over mels of 300-1800 frames (tile and crop
     paths) and an unreadable file, read by the C++ loader; a BigVGAN
     directory holding ``g_00000001`` for the audio logger. Run 1 trains 4
     steps in 2 epochs, validates after each and logs every 2 steps (2
     images of each of 3 keys); checks finite losses, ``disc_factor`` 0, 0,
     2, 2, moved generator and discriminator weights (the BatchNorm
     running means among them), ``logvar`` 0, ``last.pt`` as a
     ``{"gen", "disc", "step"}`` pair, the archived YAML read back equal, the
     PNGs and wavs, no K1-K3 and exactly 73 K4 per vocoded clip. Run 2
     resumes with ``-r`` to step 6; ``cli.generate --vae_ckpt`` then serves
     one item from phase 11's directory with that ``last.pt``: the decoder's
     weights equal the checkpoint's, 481,280 samples at -23 +/- 0.5 LUFS.
     Prints per run the event time per step, host wall per step, steps/s,
     validation's wall, K4's device time per log event and peak memory;
 14. [vae-step] one full-width VAE-GAN step (batch 2, 640 frames) on the
     card and on the CPU from the same weights, batch and posterior draw:
     losses, gradients and the updated parameters agree;
 15. [voc-train-hifigan] the HiFi-GAN recipe at full width, fp32:
     ``HifiGanGenerator()`` trainable (weight norm as (v, g)), MPD (periods
     2, 3, 5, 7, 11) and MSD, the port's ``MelSpectrogram`` on the card as
     ``mel_fn``; batch 16 of 8,320 samples, AdamW(2e-4, (0.8, 0.99), 0.01),
     5 steps: finite losses, both sides' weights moved; event time per step,
     steps/s and peak memory;
 16. [voc-train-bigvgan] the same recipe with ``BigVGANGenerator()``'s
     geometry, trainable and unfused, MPD and MRD, batch 4, 4 steps; the
     recipe refuses the ``use_fused=True`` generator; the trained generator
     folded, saved as ``g_<step>`` and served through ``build_vocoder`` on a
     1500-frame mel: exactly 73 K4 launches, within 2e-3 of the trained
     unfused generator on the card;
 17. [voc-train-pwg] the ParallelWaveGAN recipe at full width
     (``ParallelWaveGANGenerator()`` trainable and unfused,
     ``ParallelWaveGANDiscriminator()``, RAdam 1e-4 / 5e-5 at eps 1e-6,
     batch 6 of 25,600 samples, lambda_adv 4, ``disc_start`` 2 in 4 steps):
     the discriminator unchanged before the gate and moved after it; the
     trained generator saved as ``checkpoint-<n>steps.pkl`` and served through
     ``build_vocoder``: exactly 30 K5 launches, within 2e-3 of the unfused
     generator on the same noise;
 18. [voc-step] one step of each recipe at full width (batch 1, 8,320
     samples) on the card and on the CPU from the same weights and batch:
     losses within 1e-4, gradients within 1e-3 of their parameter's scale;
 19. [prep-cli] (after phase 13, from phase 11's directory) 8 synthetic 20 s
     vocal/accompaniment pairs (44.1 kHz stereo int16, tones and noise) and a
     silent pair, a prompts TSV, note and beat dicts and a music-feature TSV:
     ``make_manifest`` (18 rows), ``mel_extract`` extract on the card (the
     silent pair skipped), ``addmel2tsv`` (16 rows kept, 2 dropped), the
     ``vocal_mel_path`` join, ``postprocess`` (8 items, 1500-frame midi and
     beats); one clip's mel on the card against the port's CPU mel (1e-4)
     and timed (CUDA events, median); then ``cli.train`` on the shipped YAML
     for 2 steps from ``total.tsv`` and ``midi.npy`` (300 copies of the rows
     as the held-out set), 4/4/4 K1-K3 launches per step;
 20. [ddp] ``cli.train`` on the shipped YAML for 4 steps in this process,
     without a process group and then under the torchrun environment
     (NCCL, world size 1), each item's draws seeded by its index: losses
     within 1e-6, K1-K3 launches per step as phase 12, the DiT's gradient
     all-reduce timed per step; ``python -m torch.distributed.run
     --standalone --nproc_per_node 1 -m versband_tpu_torch.cli.train`` for 2
     steps: exit 0, one run directory, one ``last.pt`` at step 2;
     ``--devices 2`` (one more than the host's cards) raises naming the
     host's card count;
 21. [audioldm] ``AudioLDM`` built through the resolver from the shipped
     YAML's ``model.params`` (target ``ldm.models.diffusion.audioldm.
     LatentDiffusion``, random fp32 weights from SEED), ``[serve]``'s
     conditioning, HiFi-GAN as ``build_vocoder`` builds it, and CLAP at
     ``text/clap.py``'s defaults over a bert-base-uncased-shaped directory
     written under ``build/`` (random weights, a WordPiece ``tokenizer.json``
     over the caption words): ``generate_batch`` with DDIM (3 candidates,
     S 200, eta 1, CFG 2.0) and with PLMS (S 50), then ``ddpm_sample_loop`` at
     B 1 without CFG over 500 timesteps (the schedule's 1000 cut to half, the
     same linear range); exactly 4 K1 launches per model
     call (4 S, 4 (S + 1), 4 T); every candidate 481,280 finite samples; K1
     at ``[6, 752, 8, 96]`` fp32 against its plain version and timed with
     its bound and SDPA; card against CPU at 5 steps over 256 mel frames
     (latents after DDIM and PLMS, the candidates' CLAP embeddings, the BERT
     states: 2e-3; the same chosen row); ms per step of each sampler, the
     ``generate_batch`` wall, Cnn14 per candidate, BERT per call and the
     rerank's share;
 22. [timefreq-cli] (after phase 20, from phase 11's directory)
     ``cli.generate.main`` on configs/vocal2music.yaml with ``unet_config``
     swapped for ``VideoFlagLargeDiT`` (``TimeFreqMoeDiT``) at its published
     widths (hidden 1152, depth 28, 16 heads, 8 time and 8 frequency experts;
     ~5.2 B parameters, built on the card), its zero-init layers from a
     partial checkpoint, 1 item at scale 2 (CFG, 24 Euler steps at B 2 x T
     752), BigVGAN: exactly 73 K4 and 0 K1 launches, the wav 481,280 samples
     at -23 +/- 0.5 LUFS; parameter count, ms and TFLOP/s per Euler step,
     host wall and device time per stage, the builds' wall, peak memory;
 23. [legacy-modules] (after phase 18) the six ConcatDiT variants
     (``HybridDiT2MLP2`` in both fuse modes), ``TimeFreqMoeDiT``,
     ``SpatialTransformer`` with and without context, ``VQModel`` and
     ``VQModelInterface`` at hidden 64-128, depth 2, zero-init weights drawn:
     card against CPU within 2e-3 of scale, VQ indices equal, no K1;
 24. [ae2d] AudioLDM's first stage (``AutoencoderKL2D``, ch 128, ch_mult
     1-2-4, z 8) on a [2, 1, 1024, 64] log-mel image: ``encode().mode()`` and
     ``decode`` timed on the card, card against CPU within 2e-3 of scale;
 25. [concat-order] ``LatentDiffusionOrder`` (through the resolver) over
     ``ConcatOrderDiT`` at its class defaults (hidden 1152, depth 28, 16
     heads; ~4.4 B parameters) and the shipped VAE; two ``|``-separated
     instrument captions through the WordPiece tokenizer (bert-base-uncased's
     ids) and a BERT of bert-base-uncased's geometry (random) at 64 tokens,
     random orders; DDIM S 25, eta 0, batch 2, no CFG, decode, HiFi-GAN:
     2 x 481,280 finite samples, no K1; ms and TFLOP/s per DDIM step, wall,
     peak memory;
 26. [tp] (after phase 20) tensor and expert parallelism: 4 ranks share
     cuda:0 over a gloo group (``file://`` rendezvous), each builds the
     training phase's full-width CFM from SEED, and ``CFMTrainer(mesh=)``
     takes 3 steps (draws fixed; Adam eps 1e-3, LR 1e-3) at (1 data, 2
     model) and at (2, 2), each rank on its 4 of the 8 heads (K1 forward,
     K2/K3 backward: 4/4/4 a step, asserted) and its 2 of each 4 experts;
     held to the same steps in this process (losses and gradient norm 1e-4
     relative, the gathered parameters 1e-3 x LR x each leaf's scale); the
     (1, 2) run's whole checkpoint resumed here without a group, its 4th
     loss against the uninterrupted run's (1e-4); event ms a step per rank,
     model-axis all-reduces and bytes a step, parameter and Adam bytes per
     rank against one process (ranks sharing one card: not a multi-card
     figure);
 27. [tp-legacy] (after phase 26) the model axis for the legacy backbones,
     ranks sharing cuda:0 over gloo, fp32, TF32 off, Adam eps 1e-3, LR 1e-3:
     (a) ``VideoFlagLargeDiT`` at its published widths, depth cut to 4,
     through ``cli.train --devices 2 --n_model 2`` (the ranks started as a
     launcher starts them) on configs/vocal2music.yaml with ``unet_config``
     swapped (batch 4, 1536-frame mels, no validation set or loggers), 3
     steps against the same CLI run in this process, its whole checkpoint
     resumed here for a 4th step on fixed draws; then ``CFMTrainer(mesh=)``
     at (2, 2) on fixed draws against the same steps here; each rank holds
     8 of 16 heads and 4 of 8 frequency experts per block and all 8 time
     experts, 0 K1/K2/K3 (asserted); (b) a ConcatDiT at hidden 1152, depth
     2, (1, 2): nothing cut, bytes per rank the one process's; (c) rank 0's
     parameters, gradients and Adam state at depth 28, cut at (1, 2) and
     (1, 4), allocated on the card against the arithmetic (bars as [tp]);
 28. prints the whole run's wall time, the kernel table as JSON, then
     ``{"ok": true, ...}`` last.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import ctypes
import functools
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from versband_tpu_torch.cli.generate import build_vocoder
from versband_tpu_torch.data.manifests import write_tsv
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
VOCODERS = ("hifigan", "bigvgan", "pwg", "nsf")  # served in this order; hifigan in bf16
NSF_DIR = Path("build") / "chip_smoke_nsf"  # [nsf]'s checkpoint directory
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
# [bf16-serve]: the JAX package's own bf16-against-fp32 gaps, relative L2,
# of bench.py's jitted composition at this width on bf16_serve_inputs(), stage
# by stage as phase_bf16_serve takes them; measured on the CPU by
# tests/test_torch_port_bf16_serving.py's slow case. The card's bf16 serving
# must stay within BF16_BAR_FACTOR of each.
BF16_JAX_GAPS = {"latent": 0.01033885984112623, "mel": 0.019253403687978607,
                 "waveform": 0.00542955584753499, "end_to_end": 0.007883096133353406}
BF16_BAR_FACTOR = 1.5
# The end-to-end gap must exceed the waveform stage's by this factor: it adds
# the mel's own gap to the vocoder's rounding, so a vocoder whose output does
# not follow its mel (an init that renders a near-silent click gave 1.0005)
# fails it. The JAX package's ratio on these weights is 1.45.
BF16_E2E_OVER_WAVEFORM = 1.2
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
CLI_WORK = Path("build") / "chip_smoke_cli"  # [cli] and [train-cli] run from here
HIFIGAN_DIR = Path("useful_ckpts") / "hifigan"  # the YAML's AudioLogger vocoder_ckpt
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

    # HiFi-GAN NSF at full width, f0 estimated from the mel, the source's
    # draws (initial phases, noise) injected on both sides
    from versband_tpu_torch.vocoder.nsf import NSFHifiGanGenerator, estimate_f0_from_mel

    torch.manual_seed(SEED + 3)
    nsf = NSFHifiGanGenerator().eval()
    nsf.load_state_dict(scaled_conv_weights(nsf, SEED + 3))
    nmel = (rng.randn(1, 80, 48) - 2.0).astype(np.float32)
    nmel[:, 12, :] += 3.0  # a voiced band
    f0 = torch.from_numpy(estimate_f0_from_mel(nmel[0]))[None]
    draws = (torch.from_numpy(rng.rand(1, 1, 9).astype(np.float32)),
             torch.from_numpy(rng.randn(1, 48 * HOP, 9).astype(np.float32)))
    ref = nsf(torch.from_numpy(nmel), f0, init_phase=draws[0], noise=draws[1])
    nsf.to(dev)
    out = nsf(torch.from_numpy(nmel).to(dev), f0.to(dev), init_phase=draws[0].to(dev),
              noise=draws[1].to(dev))
    err = _max_diff(out, ref)
    print(f"[modules] HiFi-GAN NSF fp32 {tuple(ref.shape)} card vs CPU (draws injected, "
          f"{int((f0 > 0).sum())}/{f0.shape[1]} frames voiced): max|d| {err:.3e} "
          f"(tol {MODULE_TOL:g}), |out|max {ref.abs().max():.3f}")
    if not (err <= MODULE_TOL and ref.abs().max() > 0):
        raise AssertionError(f"HiFi-GAN NSF on the card disagrees with the CPU: {err}")


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
    if family == "nsf":  # as cli.generate writes it: cut to 20.0 s, -23 LUFS
        from versband_tpu_torch.dsp.loudness import integrated_loudness, normalize_loudness

        for i, w in enumerate(wavs):
            out = normalize_loudness(w[: CLI_T_MEL * HOP], CLI_LUFS)
            lufs = integrated_loudness(out, SR)
            print(f"[nsf] request {i}: {out.shape[0]} samples, finite "
                  f"{np.isfinite(out).all()}, {lufs:.3f} LUFS after normalisation")
            if not (out.shape == (CLI_T_MEL * HOP,) and np.isfinite(out).all()
                    and abs(lufs - CLI_LUFS) <= CLI_LUFS_TOL):
                raise AssertionError(f"[nsf] request {i}: {out.shape} samples, {lufs} LUFS")
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
        if family == "nsf":
            voc = build_vocoder("nsf", write_nsf_dir(NSF_DIR, SEED + 30), device=dev)
        elif family != "hifigan":
            voc = build_vocoder(family, device=dev)
        served[family] = serve_family(family, cfm, voc, uncond, requests)
    shutil.rmtree(NSF_DIR, ignore_errors=True)
    return served


def bf16_serve_inputs() -> dict:
    """[bf16-serve]'s weights and request, made on the CPU from SEED (so the
    JAX package's gaps can be measured on the same ones): the shipped-width
    DiT (zero-init layers drawn), VAE and HiFi-GAN in fp32 (its conv weights
    drawn N(0, 1/fan_in), so that the waveform follows the mel), one clip's
    cond and uncond, and the start noise in bf16."""
    torch.manual_seed(SEED + 40)
    dit = BandMoeDiT(**DIT).eval()
    perturb_zero_init(dit, SEED + 40)
    vae = AutoencoderKL(**VAE).eval()
    voc = HifiGanGenerator().eval()
    voc.load_state_dict(scaled_conv_weights(voc, SEED + 40))
    g = torch.Generator().manual_seed(SEED + 41)
    cond = {"caption": torch.randn(1, 80, 1024, generator=g).to(DTYPE),
            "acoustic": {"midi": torch.randint(0, 128, (1, 1, T_MEL), generator=g),
                         "beats": torch.randint(0, 2, (1, 1, T_MEL), generator=g)}}
    uncond = {"caption": torch.zeros(1, 80, 1024, dtype=DTYPE),
              "acoustic": {"midi": torch.full((1, 1, T_MEL), 128),
                           "beats": torch.full((1, 1, T_MEL), 2)}}
    z0 = torch.randn(1, 20, T_LAT, generator=g).to(DTYPE)
    return dict(dit=dit, vae=vae, voc=voc, cond=cond, uncond=uncond, z0=z0)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


@torch.inference_mode()
def phase_bf16_serve(dev) -> dict:
    """[bf16-serve] (phase 8b): the bf16 serving path against the fp32 one on
    one set of weights, stage by stage; returns the K1 launches."""
    t0 = time.perf_counter()
    w = bf16_serve_inputs()
    cfm, voc = {}, {}
    for dt in (torch.float32, DTYPE):
        cfm[dt] = CFM(unet_config=dict(target="versband_tpu.models.dit.BandMoeDiT", params=DIT),
                      first_stage_config=dict(
                          target="versband_tpu.models.autoencoder.AutoencoderKL", params=VAE),
                      mel_dim=20, scale_factor=1.0, device=dev, dtype=dt)
        cfm[dt].model.load_state_dict(w["dit"].state_dict())
        cfm[dt].first_stage.load_state_dict(w["vae"].state_dict())
        voc[dt] = build_vocoder("hifigan", device=dev, dtype=dt)
        voc[dt].model.load_state_dict(w["voc"].state_dict())

    def tree(c, dt):
        return {"caption": c["caption"].to(dev, dt),
                "acoustic": {k: v.to(dev) for k, v in c["acoustic"].items()}}

    z, mel, wav, end, k1 = {}, {}, {}, {}, {}
    for dt in (torch.float32, DTYPE):
        torch.cuda.synchronize()
        n0 = fa.LAUNCHES
        z[dt] = cfm[dt].sample_cfg(tree(w["cond"], dt), CFG_SCALE, tree(w["uncond"], dt),
                                   x_latent=w["z0"].to(dev, dt), timesteps=STEPS)
        torch.cuda.synchronize()
        k1[dt] = fa.LAUNCHES - n0
    # decode and vocode each take the fp32 stage's output rounded to bf16 in both dtypes
    z_in = z[torch.float32].to(DTYPE)
    for dt in (torch.float32, DTYPE):
        mel[dt] = cfm[dt].decode_first_stage(z_in.to(dt))
    mel_in = mel[torch.float32].to(DTYPE)
    for dt in (torch.float32, DTYPE):
        wav[dt] = voc[dt].waveform(mel_in.to(dt))
        end[dt] = voc[dt].waveform(cfm[dt].decode_first_stage(z[dt]))
    gaps = {name: _rel_l2(v[DTYPE], v[torch.float32])
            for name, v in (("latent", z), ("mel", mel), ("waveform", wav), ("end_to_end", end))}
    finite = all(bool(torch.isfinite(v[dt]).all()) for v in (z, mel, wav, end) for dt in v)
    wall = time.perf_counter() - t0
    for name, gap in gaps.items():
        bar = BF16_BAR_FACTOR * BF16_JAX_GAPS[name]
        print(f"[bf16-serve] {name}: bf16 against fp32 relative L2 {gap:.4e}, bar {bar:.4e} "
              f"({BF16_BAR_FACTOR:g} x the JAX package's {BF16_JAX_GAPS[name]:.4e})")
    print(f"[bf16-serve] K1 launches: bf16 clip {k1[DTYPE]}, fp32 clip {k1[torch.float32]}; "
          f"finite {finite}; the phase took {wall:.1f} s")
    bad = {k: v for k, v in gaps.items() if not v <= BF16_BAR_FACTOR * BF16_JAX_GAPS[k]}
    follows = gaps["end_to_end"] > BF16_E2E_OVER_WAVEFORM * gaps["waveform"]
    print(f"[bf16-serve] end to end over waveform {gaps['end_to_end'] / gaps['waveform']:.3f} "
          f"(must exceed {BF16_E2E_OVER_WAVEFORM:g}: the waveform follows the mel)")
    if bad or not follows or not finite or wav[DTYPE].shape != (1, T_MEL * HOP) \
            or k1[DTYPE] != LAUNCHES_PER_CLIP or k1[torch.float32] != LAUNCHES_PER_CLIP:
        raise AssertionError(f"[bf16-serve] gaps over their bars {bad}, end to end over "
                             f"waveform {follows}, finite {finite}, K1 "
                             f"{k1}, waveform {tuple(wav[DTYPE].shape)}")
    del cfm, voc
    torch.cuda.empty_cache()
    return {"k1": k1[DTYPE] + k1[torch.float32], "gaps": gaps, "wall_s": wall}


def scaled_conv_weights(model: torch.nn.Module, seed: int) -> dict:
    """The model's state_dict with every conv weight drawn N(0, 1/fan_in):
    the vocoders' own init (N(0, 0.01)) renders a near-silent click whose
    peak the -23 LUFS gain would push past full scale, where the limiter
    leaves it below -23; these weights render noise-like audio."""
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=g) / math.sqrt(v[0].numel())
                if v.ndim == 3 else v) for k, v in model.state_dict().items()}


def write_nsf_dir(root: Path, seed: int) -> str:
    """A HiFi-GAN NSF directory: ``NSFHifiGanGenerator()``'s defaults (512
    channels, rates 5/4/4/4) as ``model_ckpt_steps_1.ckpt``, the layout
    ``HifiGAN_NSF`` reads (the newest ``model_ckpt_steps_*``)."""
    from versband_tpu_torch.vocoder.nsf import NSFHifiGanGenerator

    root.mkdir(parents=True, exist_ok=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        torch.save(scaled_conv_weights(NSFHifiGanGenerator(), seed),
                   root / "model_ckpt_steps_1.ckpt")
    return str(root)


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
    HiFi-GAN directory (default geometry) with a ``model_gen.pt`` at the
    YAML's ``useful_ckpts/hifigan``, its conv weights N(0, 1/fan_in)
    (``scaled_conv_weights``)."""
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
    (root / HIFIGAN_DIR).mkdir(parents=True, exist_ok=True)
    torch.save(scaled_conv_weights(voc, seed), root / HIFIGAN_DIR / "model_gen.pt")
    return dict(manifest=str(root / "manifest"), midi=str(root / "midi.npy"),
                dit=str(root / "dit.pt"), vae=str(root / "vae.pt"),
                vocoder=str(root / HIFIGAN_DIR))


def _check_wav(tag: str, path: Path, n: int) -> float:
    """A written wav: ``n`` finite, non-silent samples at -23 +/- 0.5 LUFS."""
    from scipy.io import wavfile

    from versband_tpu_torch.dsp.loudness import integrated_loudness

    sr, pcm = wavfile.read(path)
    wav = pcm.astype(np.float32) / 32768.0
    lufs = integrated_loudness(wav, sr)
    print(f"{tag} {path.name}: {wav.shape[0]} samples at {sr} Hz, finite "
          f"{np.isfinite(wav).all()}, std {wav.std():.4f}, {lufs:.3f} LUFS")
    if not (sr == SR and wav.shape == (n,) and np.isfinite(wav).all() and wav.std() > 0
            and abs(lufs - CLI_LUFS) <= CLI_LUFS_TOL):
        raise AssertionError(f"{tag} {path}: {wav.shape} samples, {lufs} LUFS")
    return lufs


def phase_cli(dev) -> int:
    """The inference CLI on the shipped YAML (phase 11); returns its K1
    launches. Leaves ``CLI_WORK`` (the T5 directory, HiFi-GAN, VAE) for
    phase 12."""
    from versband_tpu_torch.cli import generate as cli
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
    for path in wavs:
        _check_wav(f"[cli] {path.parent.name}", path, (CLI_T_MEL + 7) // 8 * 8 * HOP)

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
    return k1


# [train-cli]: the dataset of configs/vocal2music.yaml holds out its first 300
# rows for validation; 16 train rows at the shipped batch of 8 make 2 batches
# an epoch. 8 distinct 24 s mels (1800 frames) make the 1500-frame crop run.
TRAIN_CLI_VALID, TRAIN_CLI_TRAIN, TRAIN_CLI_UNIQUE, TRAIN_CLI_T_MEL = 300, 16, 8, 1800
TRAIN_CLI_STEPS, TRAIN_CLI_RESUME_STEPS, TRAIN_CLI_K = 4, 6, 2
LOG_EVERY = 2  # lightning.callbacks.image_logger.params.batch_frequency for the run
LAUNCHES_PER_LOG = (STEPS - 1) * DIT["depth"]  # log_images: one scale-1 sample, 24 steps


def write_train_manifest(root: Path, n_rows: int, n_unique: int, t_mel: int,
                         seed: int) -> tuple:
    """A training manifest under ``root`` in the reference's columns (as
    tests/test_cli_e2e.py makes them; written by the port's ``write_tsv``):
    ``n_unique`` mel and vocal-mel ``.npy`` pairs of [80, ``t_mel``] shared
    round-robin by ``n_rows`` rows, and per-row ``midi.npy``/``beats.npy``
    dicts. Returns the manifest directory and the ``midi.npy`` path."""
    rng = np.random.default_rng(seed)
    (root / "manifests").mkdir(parents=True, exist_ok=True)
    pairs = []
    for i in range(n_unique):
        mel, voc = root / f"u{i}_mel.npy", root / f"u{i}_vocal_mel.npy"
        np.save(mel, (rng.standard_normal((80, t_mel)) * 0.5 - 2.0).astype(np.float32))
        np.save(voc, (rng.standard_normal((80, t_mel)) * 0.5 - 2.0).astype(np.float32))
        pairs.append((str(mel), str(voc)))
    sec = t_mel * HOP / SR
    midi, beats, rows = {}, {}, []
    for j in range(n_rows):
        name = f"song{j}"
        midi[name] = rng.integers(40, 90, t_mel)
        beats[name] = rng.integers(0, 2, t_mel)
        mel, voc = pairs[j % n_unique]
        rows.append(dict(name=name, dataset="synthetic", mel_path=mel, vocal_mel_path=voc,
                         duration=sec, caption="piano<psep>a soft piano accompaniment",
                         key="C major", key_confidence=0.9, avg_pitch=66.0, tempo=100.0,
                         tempo_confidence=0.9, emotion="['calm']", wav_len=sec, audio_path=""))
    write_tsv(str(root / "manifests" / "music.tsv"), list(rows[0]), rows)
    np.save(root / "midi.npy", midi, allow_pickle=True)
    np.save(root / "beats.npy", beats, allow_pickle=True)
    return str(root / "manifests"), str(root / "midi.npy")


class _CliProbe:
    """What the CLI probes share: methods patched for the duration of a
    ``with`` (undone on exit), each timed (host wall, optionally with the
    card synchronised around it) with the launches in it; each epoch's wall
    from ``on_epoch_start`` to ``on_epoch_end`` (card synchronised there),
    less the time of the methods marked ``side`` (image and audio logging)."""

    def __init__(self):
        self.epochs, self.k4_calls, self.side_ms, self._saved = [], [], 0.0, []

    def counts(self) -> tuple:
        return launches()

    def n_steps(self) -> int:
        raise NotImplementedError

    def _patch(self, owner, name, wrapper):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, wrapper(getattr(owner, name)))

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)

    def timed(self, log: list, synced: bool, side: bool = False, extra=None):
        """A wrapper for a method: appends its wall ("ms"), launches and the
        K4 calls made in it to ``log``, with ``extra(args, out)``."""
        probe = self

        def wrap(fn):
            def call(obj, *a, **k):
                if synced:
                    torch.cuda.synchronize()
                n0, k0, t0 = probe.counts(), len(probe.k4_calls), time.perf_counter()
                out = fn(obj, *a, **k)
                if synced:
                    torch.cuda.synchronize()
                row = {"ms": (time.perf_counter() - t0) * 1e3,
                       "launches": tuple(b - a for a, b in zip(n0, probe.counts())),
                       "k4_calls": probe.k4_calls[k0:]}
                if side:
                    probe.side_ms += row["ms"]
                if extra is not None:
                    row.update(extra(a, out))
                log.append(row)
                return out
            return call
        return wrap

    def epoch_clock(self, fn):
        """A wrapper for the trainer's ``_dispatch``."""
        probe = self

        def call(trainer, name, *a):
            if name == "on_epoch_start":
                probe.epochs.append({"t0": time.perf_counter(), "side0": probe.side_ms,
                                     "step0": probe.n_steps()})
            out = fn(trainer, name, *a)
            if name == "on_epoch_end":
                torch.cuda.synchronize()
                e = probe.epochs[-1]
                e.update(ms=(time.perf_counter() - e["t0"]) * 1e3,
                         side_ms=probe.side_ms - e["side0"], steps=probe.n_steps() - e["step0"])
            return out
        return call


class _TrainCliProbe(_CliProbe):
    """For the duration of a ``with``: the train steps' launches and events
    (the step functions the trainer builds are wrapped where the trainer
    module makes them); the wall and launches of ``_validate``,
    ``log_images``, ``AudioLogger.log_img`` (vocoding and writing the logs;
    ``ImageLogger.log_img`` inside it, the PNGs), ``save_checkpoint`` and
    the caption tower (``_encode_caption_list``, on the prefetch thread);
    and each epoch's wall. The wrappers synchronise the card before
    ``_validate``, ``log_images`` and ``save_checkpoint`` start, so the step
    work queued before them is not counted as theirs."""

    def __init__(self):
        from versband_tpu_torch.train import callbacks as cmod
        from versband_tpu_torch.train import trainer as tmod

        super().__init__()
        self.tmod, self.cmod = tmod, cmod
        self.steps, self.vals, self.logs, self.writes, self.towers = [], [], [], [], []
        self.pngs, self.saves, self.metrics = [], [], []

    def n_steps(self) -> int:
        return sum(n for n, _, _ in self.steps)

    def __enter__(self):
        probe, cls = self, self.tmod.CFMTrainer

        def steps(make):
            def made(*a, **k):
                fn = make(*a, **k)

                def timed(state, batch, generator=None, given=None):
                    n0, ev = launches(), [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                    ev[0].record()
                    out = fn(state, batch, generator, given)
                    ev[1].record()
                    n = batch["image"].shape[0] if batch["image"].ndim == 4 else 1
                    probe.steps.append((n, tuple(b - a for a, b in zip(n0, launches())), ev))
                    probe.metrics.append(out)
                    return out
                return timed
            return made

        self._patch(self.tmod, "make_cfm_train_step", steps)
        self._patch(self.tmod, "make_cfm_multi_step", steps)
        self._patch(cls, "_dispatch", self.epoch_clock)
        self._patch(cls, "_validate", self.timed(
            self.vals, True, extra=lambda a, out: {"batches": len(a[0]), "metrics": out}))
        self._patch(cls, "log_images", self.timed(self.logs, True, side=True))
        self._patch(self.cmod.AudioLogger, "log_img", self.timed(self.writes, False, side=True))
        self._patch(self.cmod.ImageLogger, "log_img", self.timed(self.pngs, False))
        self._patch(cls, "save_checkpoint", self.timed(self.saves, True))
        self._patch(cls, "_encode_caption_list", self.timed(
            self.towers, False, extra=lambda a, out: {"captions": len(a[0]),
                                                      "device": out.device}))
        return self


def _train_cli_run(dev, tag: str, argv: list, expect_steps: int, check=None,
                   phase: str = "train-cli") -> dict:
    """One ``cli.train.main`` in this process under a probe: checks the
    launches per step, per validation batch and per ``log_images``, and that
    the tower's output lies on ``dev``; runs ``check(run)`` on the CLI's run
    dict, then drops the run's models; prints the run's figures (as
    ``[phase]``) and returns them."""
    import gc

    from versband_tpu_torch.cli import train as cli

    run = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # count only this run's launches
    t0 = time.perf_counter()
    with _TrainCliProbe() as probe:
        rc = cli.main(argv, run=run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total, peak, trainer = launches(), torch.cuda.max_memory_allocated(), run["trainer"]
    writer = trainer.writer is not None
    depth = DIT["depth"]
    n_steps = probe.n_steps()
    bad = [(n, k) for n, k, _ in probe.steps if k != (depth * n,) * 3]
    bad += [(v["batches"], v["launches"]) for v in probe.vals
            if v["launches"] != (depth * v["batches"], 0, 0)]
    bad += [(1, g["launches"]) for g in probe.logs if g["launches"] != (LAUNCHES_PER_LOG, 0, 0)]
    want = (depth * (n_steps + sum(v["batches"] for v in probe.vals))
            + LAUNCHES_PER_LOG * len(probe.logs), depth * n_steps, depth * n_steps)
    off_card = sorted({str(t["device"]) for t in probe.towers if t["device"].type != dev.type})
    print(f"[{phase}] {tag}: main() returned {rc} in {wall:.2f} s host wall; "
          f"{trainer.global_step} steps in {len(probe.steps)} calls of "
          f"{[n for n, _, _ in probe.steps]}; {len(probe.vals)} validations of "
          f"{[v['batches'] for v in probe.vals]} batches; {len(probe.logs)} log_images; "
          f"K1/K2/K3 launches {total} (want {want}); the tower ran {len(probe.towers)} "
          f"times on {sorted({str(t['device']) for t in probe.towers})}")
    if (rc != 0 or trainer.global_step != expect_steps or bad or total != want or off_card
            or not probe.towers):
        raise AssertionError(f"[{phase}] {tag}: rc {rc}, step {trainer.global_step}, "
                             f"launches off per call {bad}, total {total} != {want}, "
                             f"tower devices {off_card}")
    for v in probe.vals:
        loss = v["metrics"].get("val/loss_simple")
        print(f"[{phase}] {tag}: validation over {v['batches']} batches: val/loss_simple "
              f"{loss}, {v['ms']:.1f} ms host wall (synchronised)")
        if loss is None or not math.isfinite(loss):
            raise AssertionError(f"[{phase}] {tag}: validation gave {v['metrics']}")
    if check is not None:
        check(run)
    per_step = [ev[0].elapsed_time(ev[1]) / n for n, _, ev in probe.steps]
    dev_ms = statistics.median(per_step[1:] or per_step)
    epoch_ms = [e["ms"] - e["side_ms"] for e in probe.epochs]
    host_ms = sum(epoch_ms) / sum(e["steps"] for e in probe.epochs)
    tower = [t for t in probe.towers if t["captions"] == TRAIN_CLI_K * TRAIN_B]
    print(f"[{phase}] {tag}: event time per train step {dev_ms:.2f} ms (median over the "
          f"calls after the first, {['%.2f' % x for x in per_step]}), "
          f"{1e3 / dev_ms:.3f} steps/s on the card; host wall per step {host_ms:.2f} ms "
          f"({1e3 / host_ms:.3f} steps/s): epochs {['%.1f' % e['ms'] for e in probe.epochs]} ms "
          f"from on_epoch_start to on_epoch_end (card synchronised), of which image logging "
          f"{['%.1f' % e['side_ms'] for e in probe.epochs]} ms (taken out), over "
          f"{[e['steps'] for e in probe.epochs]} steps (loader, tower, copies, the first "
          f"batch's scale_by_std included); log_images {[round(g['ms'], 1) for g in probe.logs]} "
          f"ms, writing and vocoding the logs {[round(g['ms'], 1) for g in probe.writes]} ms "
          f"(of which the PNGs {[round(g['ms'], 1) for g in probe.pngs]} ms; TensorBoard "
          f"{'on' if writer else 'off'}); "
          f"save_checkpoint {[round(c['ms'], 1) for c in probe.saves]} ms; the tower per "
          f"group of {TRAIN_CLI_K * TRAIN_B} captions {[round(t['ms'], 2) for t in tower]} ms "
          f"host wall on the prefetch thread; peak memory {peak / 2 ** 30:.2f} GiB "
          f"(max_memory_allocated)")
    logdir, config = run["logdir"], run["config"]
    del run, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"logdir": logdir, "config": config, "launches": total, "device_ms": dev_ms,
            "host_ms": host_ms, "peak": peak, "probe": probe}


def phase_train_cli(dev) -> tuple:
    """The training CLI on the shipped YAML (phase 12), from ``CLI_WORK`` as
    phase 11 left it; returns the K1/K2/K3 launches of its runs and of the
    ``cli.generate`` that serves its checkpoint."""
    from versband_tpu_torch.cli import generate as gen_cli
    from versband_tpu_torch.utils.config import load_config

    config = CLI_CONFIG.resolve()
    root = CLI_WORK.resolve()
    t0 = time.perf_counter()
    manifest, midi = write_train_manifest(root / "train_data", TRAIN_CLI_VALID + TRAIN_CLI_TRAIN,
                                          TRAIN_CLI_UNIQUE, TRAIN_CLI_T_MEL, SEED + 30)
    vae = root / "vae.pt"  # phase 11's, at the shipped width
    print(f"[train-cli] manifest of {TRAIN_CLI_VALID + TRAIN_CLI_TRAIN} rows over "
          f"{TRAIN_CLI_UNIQUE} mel pairs of [80, {TRAIN_CLI_T_MEL}] written in "
          f"{time.perf_counter() - t0:.1f} s; T5 {T5_DIR}, HiFi-GAN {HIFIGAN_DIR} and {vae.name} "
          f"from phase 11")
    paths = [f"data.params.main_spec_dir_path={manifest}",
             f"data.params.other_condition={midi}",
             f"model.params.first_stage_config.params.ckpt_path={vae}",
             f"lightning.callbacks.image_logger.params.batch_frequency={LOG_EVERY}"]
    base = ["-b", str(config), "-t", "-l", "logs", "-s", str(SEED),
            "--steps_per_call", str(TRAIN_CLI_K)]
    run1 = base + ["-n", "prefetch", "--max_steps", str(TRAIN_CLI_STEPS), "--max_epochs", "2",
                   "--prefetch_groups", "1", *paths]
    inline = base + ["-n", "inline", "--max_steps", str(TRAIN_CLI_STEPS), "--max_epochs", "2",
                     "--prefetch_groups", "0", *paths]
    cwd = os.getcwd()
    gen_stats = []
    try:
        os.chdir(root)  # the YAML's relative useful_ckpts/: resolve here
        vae_saved = torch.load(vae, map_location="cpu", weights_only=True)
        seen = {}

        def check_run1(run):
            trainer = run["trainer"]
            audio = [cb for cb in trainer.callbacks if type(cb).__name__ == "AudioLogger"]
            seen["loaded"] = all(torch.equal(v.cpu(), vae_saved[k])
                                 for k, v in trainer.cfm.first_stage.state_dict().items())
            seen["vocoder"] = type(audio[0].vocoder).__name__ if audio and audio[0].vocoder \
                else None

        first = _train_cli_run(dev, "run 1 (prefetch 1)", run1, TRAIN_CLI_STEPS, check_run1)
        logdir = Path(first["logdir"])
        again = _train_cli_run(dev, "run 1 again (prefetch 0)", inline, TRAIN_CLI_STEPS)
        meta = json.loads((logdir / "checkpoints" / "last_step.json").read_text())
        (project,) = sorted((logdir / "configs").glob("*-project.yaml"))
        pngs = sorted((logdir / "images" / "train").glob("*.png"))
        wavs = sorted((logdir / "audio" / "train").glob("*.wav"))
        n_logs = len(first["probe"].logs)
        print(f"[train-cli] run 1: last_step.json {meta}; {project.name} read back equal "
              f"{load_config(project) == first['config']}; {len(pngs)} PNGs, "
              f"{len(wavs)} wavs from {n_logs} log_images (vocoder {seen['vocoder']}); "
              f"first stage loaded from {vae.name}: {seen['loaded']}")
        if not ((logdir / "checkpoints" / "last.pt").exists()
                and meta.get("step") == TRAIN_CLI_STEPS and meta.get("scale_factor", 1.0) != 1.0
                and load_config(project) == first["config"] and seen["loaded"]
                and n_logs == TRAIN_CLI_STEPS // LOG_EVERY and seen["vocoder"]
                and len(pngs) == len(wavs) == n_logs * 2 * 4
                and len(first["probe"].vals) == 2):
            raise AssertionError("[train-cli] run 1's checkpoint, config, logs or first stage")

        resumed = _train_cli_run(
            dev, "run 2 (-r, resumed)", ["-r", str(logdir), "-t", "--max_steps",
                                    str(TRAIN_CLI_RESUME_STEPS), "--steps_per_call",
                                    str(TRAIN_CLI_K), "--no-test"], TRAIN_CLI_RESUME_STEPS)
        meta2 = json.loads((logdir / "checkpoints" / "last_step.json").read_text())
        if meta2.get("step") != TRAIN_CLI_RESUME_STEPS or \
                resumed["probe"].n_steps() != TRAIN_CLI_RESUME_STEPS - TRAIN_CLI_STEPS:
            raise AssertionError(f"[train-cli] run 2 did not resume at step {TRAIN_CLI_STEPS}: "
                                 f"{meta2}")

        reset_launches()
        argv = ["--config", str(project), "--ckpt", str(logdir / "checkpoints" / "last.pt"),
                "--vocoder_ckpt", str(root / HIFIGAN_DIR), "--manifest", manifest,
                "--other_condition", midi, "--scales", "1", "--num_items", "1",
                "--max_sec", "30", "--pad_to", str(T_MEL), "--seed", str(SEED),
                "--save_dir", "out_train"]
        rc = gen_cli.main(argv, stats=gen_stats)
        torch.cuda.synchronize()
        n_gen = launches()
        gen_wavs = sorted((root / "out_train").rglob("*.wav"))
    finally:
        os.chdir(cwd)
    print(f"[train-cli] host wall per step through fit: prefetch 1 {first['host_ms']:.2f} ms, "
          f"prefetch 0 {again['host_ms']:.2f} ms, resumed (prefetch 1) "
          f"{resumed['host_ms']:.2f} ms; event time per step {first['device_ms']:.2f} / "
          f"{again['device_ms']:.2f} / {resumed['device_ms']:.2f} ms")
    if rc != 0 or len(gen_wavs) != 1 or n_gen != (LAUNCHES_PER_CLIP, 0, 0):
        raise AssertionError(f"[train-cli] cli.generate: rc {rc}, {len(gen_wavs)} wavs, "
                             f"launches {n_gen}")
    print(f"[train-cli] cli.generate from the trained checkpoint ({T_MEL} frames, scale 1): "
          f"K1 {n_gen[0]}; stages " + ", ".join(
              f"{st} {gen_stats[0][st + '_ms']:.1f} ms" for st in gen_cli.STAGES
              if st + "_ms" in gen_stats[0]))
    _check_wav("[train-cli] cli.generate", gen_wavs[0], T_MEL * HOP)
    counts = [r["launches"] for r in (first, again, resumed)] + [n_gen]
    return tuple(sum(c[i] for c in counts) for i in range(3))


# [vae-train-cli]: configs/ae_accomp.yaml's data: batch 20, 624-frame crops
# (padded to 640, the 128-frame bucket), the first 100 manifest rows held out
# for validation (valid_head); 40 train rows make 2 batches an epoch. Mels of
# 8 lengths, below the crop (tiled) and above it (cropped), and one unreadable
# file (a zero mel).
VAE_B, VAE_CROP, VAE_T_PAD = 20, 624, 640
VAE_VALID, VAE_TRAIN_ROWS = 100, 40
VAE_T_MELS = (300, 500, 624, 700, 900, 1200, 1800)
VAE_STEPS, VAE_RESUME_STEPS = 4, 6
VAE_DISC_START = 2  # lowered from 80001 so both sides of the gate run
VAE_LOG_EVERY, VAE_MAX_IMAGES = 2, 2  # image_logger batch_frequency, max_images
VAE_LOG_KEYS = ("inputs", "reconstructions", "samples")
VAE_CONFIG = Path("configs") / "ae_accomp.yaml"  # as committed
BIGVGAN_DIR = Path("useful_ckpts") / "bigvgan"  # the AudioLogger's vocoder_cfg.ckpt_vocoder
# One full-width VAE-GAN step (batch 2, 640 frames), card against CPU:
# losses relative to themselves; per parameter the gradient's max|d| over its
# scale, its own largest floored at STEP_GRAD_FLOOR x the largest of all, as
# phase 10; and the updated parameters within VAE_PARAM_TOL x LR on the
# elements whose CPU gradient is at least VAE_SIGN_FLOOR of that scale (10x
# the gradient tolerance, so its sign is settled). Adam's first step moves
# an element by LR g / (|g| + eps), LR x sign(g) where |g| >> eps; an element
# whose gradient is within summation noise of 0 (the attention's key bias
# has an exactly-zero gradient: softmax ignores a shift of a row of scores)
# moves by +-LR either way, so it shows nothing.
VAE_LOSS_TOL, VAE_SIGN_FLOOR, VAE_PARAM_TOL = 1e-4, 1e-2, 1e-3


def write_vae_train_data(root: Path, seed: int) -> tuple:
    """The stage-1 manifest (the port's ``write_tsv``) over ``VAE_T_MELS`` mels
    and one unreadable file, and a BigVGAN directory at ``BIGVGAN_DIR`` holding
    the reference's ``g_00000001`` (``{"generator": state_dict}``, the
    geometry of phase 8's ``BigVGANGenerator()``, random weights from
    ``seed``). Returns the manifest directory and the BigVGAN directory."""
    rng = np.random.default_rng(seed)
    data = root / "vae_data"
    (data / "manifests").mkdir(parents=True, exist_ok=True)
    paths = []
    for i, t in enumerate(VAE_T_MELS):
        p = data / f"mel{i}_{t}.npy"
        np.save(p, (rng.standard_normal((80, t)) * 0.5 - 2.0).astype(np.float32))
        paths.append(str(p))
    bad = data / "corrupt.npy"
    bad.write_bytes(b"\x93NUMPY not a mel")
    paths.append(str(bad))
    rows = [dict(name=f"song{j}", dataset="synthetic", mel_path=paths[j % len(paths)],
                 duration=1.0, caption="", audio_path="")
            for j in range(VAE_VALID + VAE_TRAIN_ROWS)]
    write_tsv(str(data / "manifests" / "music.tsv"), list(rows[0]), rows)
    (root / BIGVGAN_DIR).mkdir(parents=True, exist_ok=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        torch.save({"generator": BigVGANGenerator().state_dict()},
                   root / BIGVGAN_DIR / "g_00000001")
    return str(data / "manifests"), str(root / BIGVGAN_DIR)


class _VaeCliProbe(_CliProbe):
    """For the duration of a ``with``: each VAE-GAN step's events, metrics and
    launches (the step function is wrapped where the trainer module makes
    it); the wall, metrics and launches of ``_validate`` and, inside it, of
    ``save_monitored`` (a checkpoint write); the wall of ``log_images`` and
    of ``AudioLogger.log_img`` with the K4 launches in it, and each K4 call
    there (its shape and parameters, and CUDA events around the name
    ``vocoder/bigvgan.py`` calls, which take in the host's gaps where the
    card waits for it); ``save_checkpoint``'s wall; each epoch's wall."""

    def __init__(self):
        from versband_tpu_torch.train import callbacks as cmod
        from versband_tpu_torch.train import checkpoints as ckmod
        from versband_tpu_torch.train import trainer as tmod
        from versband_tpu_torch.vocoder import bigvgan as bmod

        super().__init__()
        self.tmod, self.cmod, self.ckmod, self.bmod = tmod, cmod, ckmod, bmod
        self.steps, self.vals, self.monitored, self.logs, self.writes, self.saves = \
            [], [], [], [], [], []

    def counts(self) -> tuple:
        return launches() + (fa1.LAUNCHES,)

    def n_steps(self) -> int:
        return len(self.steps)

    def __enter__(self):
        probe, cls = self, self.tmod.VAETrainer

        def steps(make):
            def made(*a, **k):
                fn = make(*a, **k)

                def timed(gen_state, disc_state, batch, generator=None, given=None):
                    n0, ev = probe.counts(), [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                    ev[0].record()
                    out = fn(gen_state, disc_state, batch, generator, given)
                    ev[1].record()
                    probe.steps.append({"metrics": out, "events": ev, "shape": tuple(
                        batch["image"].shape), "launches": tuple(
                            b - a for a, b in zip(n0, probe.counts()))})
                    return out
                return timed
            return made

        def k4(fn):
            def call(x, alpha, beta=None, logscale=True):
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
                out = fn(x, alpha, beta, logscale)
                ev[1].record()
                probe.k4_calls.append({"events": ev, "key": (tuple(x.shape), x.dtype,
                                                             beta is None, bool(logscale)),
                                       "params": (alpha, beta)})
                return out
            return call

        self._patch(self.tmod, "make_vae_train_step", steps)
        self._patch(self.bmod, "fused_alias_free_snake", k4)
        self._patch(cls, "_dispatch", self.epoch_clock)
        self._patch(cls, "_validate", self.timed(
            self.vals, True, extra=lambda a, out: {"batches": len(a[0]), "metrics": out}))
        self._patch(cls, "log_images", self.timed(self.logs, True, side=True))
        self._patch(self.cmod.AudioLogger, "log_img", self.timed(
            self.writes, True, side=True, extra=lambda a, out: {"clips": sum(
                min(len(m), VAE_MAX_IMAGES) for m in a[1].values())}))
        self._patch(cls, "save_checkpoint", self.timed(self.saves, True))
        self._patch(self.ckmod.CheckpointManager, "save_monitored",
                    self.timed(self.monitored, True))
        return self


def k4_replay_ms(calls: list) -> float:
    """The device time of K4 over ``calls`` (the probe's records): each
    distinct (shape, type, Snake or SnakeBeta, logscale) timed once by
    ``cuda_ms`` on a random input with the call's own parameters, times the
    number of its calls."""
    groups = {}
    for c in calls:
        groups.setdefault(c["key"], [c["params"], 0])[1] += 1
    total = 0.0
    for (shape, dtype, _, logscale), ((alpha, beta), n) in groups.items():
        x = torch.randn(shape, device=alpha.device, dtype=dtype)
        total += n * cuda_ms(lambda: fa1.fused_alias_free_snake(x, alpha, beta, logscale), 20)
    return total


def _vae_cli_run(tag: str, argv: list, expect_steps: int, check=None) -> dict:
    """One ``cli.train.main`` on the stage-1 YAML under a probe: checks each
    step's metrics, the launches (no K1-K3 anywhere; K4 exactly
    ``K4_PER_CLIP`` per vocoded clip, in the audio logs only) and each
    validation; runs ``check(run)``; prints the run's figures and returns
    them."""
    import gc

    from versband_tpu_torch.cli import train as cli

    run = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # count only this run's launches
    t0 = time.perf_counter()
    with _VaeCliProbe() as probe:
        rc = cli.main(argv, run=run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total, k4_total, peak = launches(), fa1.LAUNCHES, torch.cuda.max_memory_allocated()
    trainer = run["trainer"]
    factors = [m["metrics"]["disc_factor"] for m in probe.steps]
    bad = [m["launches"] for m in probe.steps if m["launches"] != (0, 0, 0, 0)]
    bad += [v["launches"] for v in probe.vals + probe.logs if v["launches"] != (0, 0, 0, 0)]
    bad += [(w["clips"], w["launches"]) for w in probe.writes
            if w["launches"] != (0, 0, 0, K4_PER_CLIP * w["clips"])]
    want_k4 = K4_PER_CLIP * sum(w["clips"] for w in probe.writes)
    print(f"[vae-train-cli] {tag}: main() returned {rc} in {wall:.2f} s host wall; "
          f"{trainer.global_step} steps on batches {sorted({m['shape'] for m in probe.steps})}"
          f", disc_factor per step {factors} (disc_start lowered to {VAE_DISC_START}); "
          f"{len(probe.vals)} validations of {[v['batches'] for v in probe.vals]} batches; "
          f"{len(probe.writes)} audio logs of {[w['clips'] for w in probe.writes]} clips; "
          f"K1/K2/K3 launches {total}, K4 {k4_total} (want {want_k4}: {K4_PER_CLIP} per clip)")
    if rc != 0 or trainer.global_step != expect_steps or bad or total != (0, 0, 0) \
            or k4_total != want_k4:
        raise AssertionError(f"[vae-train-cli] {tag}: rc {rc}, step {trainer.global_step}, "
                             f"launches off {bad}, K1-K3 {total}, K4 {k4_total} != {want_k4}")
    keys = ("aeloss", "discloss", "rec_loss", "kl_loss", "d_weight", "r1_penalty")
    for i, m in enumerate(probe.steps):
        vals = {k: float(m["metrics"][k]) for k in keys}
        print(f"[vae-train-cli] {tag}: step {i + 1}: " + ", ".join(
            f"{k} {x:.5g}" for k, x in vals.items()) + f", disc_factor {factors[i]}")
        if not all(math.isfinite(x) for x in vals.values()):
            raise AssertionError(f"[vae-train-cli] {tag}: step {i + 1} gave {vals}")
    for v in probe.vals:
        rec = v["metrics"].get("val/rec_loss")
        print(f"[vae-train-cli] {tag}: validation over {v['batches']} batches: "
              f"{ {k: round(x, 6) for k, x in v['metrics'].items()} }, {v['ms']:.1f} ms host "
              f"wall (synchronised)")
        if rec is None or not math.isfinite(rec):
            raise AssertionError(f"[vae-train-cli] {tag}: validation gave {v['metrics']}")
    if check is not None:
        check(run)
    per_step = [m["events"][0].elapsed_time(m["events"][1]) for m in probe.steps]
    dev_ms = statistics.median(per_step[1:] or per_step)
    host_ms = sum(e["ms"] - e["side_ms"] for e in probe.epochs) / sum(
        e["steps"] for e in probe.epochs)
    k4_wall = [sum(c["events"][0].elapsed_time(c["events"][1]) for c in w["k4_calls"])
               for w in probe.writes]
    k4_ms = [k4_replay_ms(w["k4_calls"]) for w in probe.writes]
    print(f"[vae-train-cli] {tag}: event time per train step {dev_ms:.2f} ms (median over the "
          f"steps after the first, {['%.2f' % x for x in per_step]}), {1e3 / dev_ms:.3f} "
          f"steps/s on the card; host wall per step {host_ms:.2f} ms ({1e3 / host_ms:.3f} "
          f"steps/s): epochs {['%.1f' % e['ms'] for e in probe.epochs]} ms from on_epoch_start "
          f"to on_epoch_end (card synchronised), of which image and audio logging "
          f"{['%.1f' % e['side_ms'] for e in probe.epochs]} ms (taken out), over "
          f"{[e['steps'] for e in probe.epochs]} steps (loader, C++ mel reads, copies "
          f"included); validation {[round(v['ms'], 1) for v in probe.vals]} ms; log_images "
          f"{[round(g['ms'], 1) for g in probe.logs]} ms; PNGs, vocoding and wavs per log "
          f"event {[round(w['ms'], 1) for w in probe.writes]} ms, of which K4 "
          f"{['%.3f' % x for x in k4_ms]} ms of device time ({K4_PER_CLIP} launches x "
          f"{[w['clips'] for w in probe.writes]} clips, replayed at their shapes with the "
          f"stream held busy; {['%.1f' % x for x in k4_wall]} ms between CUDA events around "
          f"the calls in the run, host gaps included); save_monitored inside validation "
          f"{[round(c['ms'], 1) for c in probe.monitored]} ms; save_checkpoint "
          f"{[round(c['ms'], 1) for c in probe.saves]} ms; peak memory {peak / 2 ** 30:.2f} GiB "
          f"(max_memory_allocated)")
    logdir, config = run["logdir"], run["config"]
    del run, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"logdir": logdir, "config": config, "k4": k4_total, "device_ms": dev_ms,
            "host_ms": host_ms, "k4_ms": k4_ms, "peak": peak, "probe": probe,
            "factors": factors}


def phase_vae_train_cli(dev) -> tuple:
    """Stage-1 training through the CLI on ``configs/ae_accomp.yaml`` (phase
    13), then ``cli.generate`` with the trained VAE from ``CLI_WORK`` as
    phase 11 left it; returns the K4 launches of its runs and the K1
    launches of that ``cli.generate``."""
    from versband_tpu_torch.cli import generate as gen_cli
    from versband_tpu_torch.cli import train as cli
    from versband_tpu_torch.train import checkpoints as ckmod
    from versband_tpu_torch.utils.config import load_config

    root, v2m = CLI_WORK.resolve(), CLI_CONFIG.resolve()
    t0 = time.perf_counter()
    manifest, bigvgan = write_vae_train_data(root, SEED + 40)
    print(f"[vae-train-cli] manifest of {VAE_VALID + VAE_TRAIN_ROWS} rows ({VAE_VALID} held out "
          f"for validation) over mels of {list(VAE_T_MELS)} frames and one unreadable file, "
          f"and {BIGVGAN_DIR}/g_00000001 written in {time.perf_counter() - t0:.1f} s")
    argv = ["-b", str(VAE_CONFIG.resolve()), "-t", "-l", "logs", "-s", str(SEED), "-n", "vae",
            "--max_steps", str(VAE_STEPS), "--max_epochs", "2",
            f"data.params.spec_dir_path={manifest}",
            f"lightning.callbacks.image_logger.params.vocoder_cfg.params.ckpt_vocoder={bigvgan}",
            f"lightning.callbacks.image_logger.params.batch_frequency={VAE_LOG_EVERY}",
            f"lightning.callbacks.image_logger.params.max_images={VAE_MAX_IMAGES}",
            f"model.params.lossconfig.params.disc_start={VAE_DISC_START}"]
    cwd = os.getcwd()
    gen_stats, loaded = [], []
    try:
        os.chdir(root)
        seen = {}

        def check_run1(run):
            tr = run["trainer"]
            vae0, loss0 = cli.build_vae_gan(run["config"]["model"], torch.device("cpu"), SEED)
            moved = {name: max((v.cpu() - ref).abs().max().item()
                               for v, ref in zip(mod.state_dict().values(),
                                                 ref_mod.state_dict().values()))
                     for name, mod, ref_mod in (("gen", tr.vae, vae0), ("disc", tr.loss, loss0))}
            bn = [k for k in tr.loss.state_dict() if k.endswith("running_mean")]
            moved["bn_running_mean"] = min(
                (tr.loss.state_dict()[k].cpu() - loss0.state_dict()[k]).abs().max().item()
                for k in bn)
            audio = [cb for cb in tr.callbacks if type(cb).__name__ == "AudioLogger"]
            seen.update(moved=moved, logvar=tr.loss.logvar.item(),
                        vocoder=type(audio[0].vocoder).__name__ if audio and audio[0].vocoder
                        else None)

        first = _vae_cli_run("run 1", argv, VAE_STEPS, check_run1)
        logdir = Path(first["logdir"]).resolve()
        ckpt = torch.load(logdir / "checkpoints" / "last.pt", map_location="cpu",
                          weights_only=False)
        meta = json.loads((logdir / "checkpoints" / "last_step.json").read_text())
        (project,) = sorted((logdir / "configs").glob("*-project.yaml"))
        pngs = sorted((logdir / "images" / "train").glob("*.png"))
        wavs = sorted((logdir / "audio" / "train").glob("*.wav"))
        n_logs = len(first["probe"].writes)
        n_clips = n_logs * len(VAE_LOG_KEYS) * VAE_MAX_IMAGES
        want_factors = [0.0 if s < VAE_DISC_START else
                        float(first["config"]["model"]["params"]["lossconfig"]["params"]
                              ["disc_factor"]) for s in range(VAE_STEPS)]
        print(f"[vae-train-cli] run 1: weights moved {seen['moved']} (max|d|; the smallest "
              f"over the BatchNorm running_means), logvar {seen['logvar']}; last.pt keys "
              f"{sorted(ckpt)} at step {ckpt['step']}, last_step.json {meta}; {project.name} read "
              f"back equal {load_config(project) == first['config']}; {len(pngs)} PNGs and "
              f"{len(wavs)} wavs from {n_logs} log events (vocoder {seen['vocoder']})")
        if not (set(ckpt) == {"gen", "disc", "step"} and ckpt["step"] == VAE_STEPS
                and meta.get("step") == VAE_STEPS and first["factors"] == want_factors
                and min(seen["moved"].values()) > 0 and seen["logvar"] == 0.0
                and load_config(project) == first["config"]
                and seen["vocoder"] == "VocoderBigVGAN" and n_logs == VAE_STEPS // VAE_LOG_EVERY
                and len(pngs) == len(wavs) == n_clips and len(first["probe"].vals) == 2):
            raise AssertionError(f"[vae-train-cli] run 1: checkpoint, gate {first['factors']}, "
                                 f"weights, logvar, config or logs")

        resumed = _vae_cli_run("run 2 (-r, resumed)", ["-r", str(logdir), "-t", "--max_steps",
                                                     str(VAE_RESUME_STEPS), "--no-test"],
                               VAE_RESUME_STEPS)
        meta2 = json.loads((logdir / "checkpoints" / "last_step.json").read_text())
        if meta2.get("step") != VAE_RESUME_STEPS or \
                len(resumed["probe"].steps) != VAE_RESUME_STEPS - VAE_STEPS:
            raise AssertionError(f"[vae-train-cli] run 2 did not resume at step {VAE_STEPS}: "
                                 f"{meta2}")

        real_load = ckmod.load_model_checkpoint

        def recording_load(model, path, *a, **k):
            loaded.append((model, str(path)))
            return real_load(model, path, *a, **k)

        last = logdir / "checkpoints" / "last.pt"
        reset_launches()
        gen_argv = ["--config", str(v2m), "--ckpt", str(root / "dit.pt"),
                    "--vae_ckpt", str(last), "--vocoder_ckpt", str(root / HIFIGAN_DIR),
                    "--manifest", str(root / "manifest"), "--other_condition",
                    str(root / "midi.npy"), "--scales", "1", "--num_items", "1",
                    "--seed", str(SEED), "--save_dir", "out_vae"]
        ckmod.load_model_checkpoint = recording_load
        try:
            rc = gen_cli.main(gen_argv, stats=gen_stats)
        finally:
            ckmod.load_model_checkpoint = real_load
        torch.cuda.synchronize()
        n_gen = launches()
        gen_wavs = sorted((root / "out_vae").rglob("*.wav"))
    finally:
        os.chdir(cwd)
    gen_sd = torch.load(last, map_location="cpu", weights_only=False)["gen"]["model"]
    vaes = [m for m, path in loaded if path == str(last)]
    dec_equal = len(vaes) == 1 and all(
        torch.equal(v.cpu(), gen_sd[f"decoder.{k}"])
        for k, v in vaes[0].decoder.state_dict().items())
    if rc != 0 or len(gen_wavs) != 1 or n_gen != (LAUNCHES_PER_CLIP, 0, 0) or not dec_equal:
        raise AssertionError(f"[vae-train-cli] cli.generate: rc {rc}, {len(gen_wavs)} wavs, "
                             f"launches {n_gen}, decoder equal to last.pt {dec_equal}")
    print(f"[vae-train-cli] cli.generate --vae_ckpt {last.name} (step {VAE_RESUME_STEPS}): "
          f"decoder weights equal to the checkpoint's {dec_equal}; K1 {n_gen[0]}")
    _check_wav("[vae-train-cli] cli.generate", gen_wavs[0], (CLI_T_MEL + 7) // 8 * 8 * HOP)
    print(f"[vae-train-cli] per run (run 1 / run 2 resumed): event time per step "
          f"{first['device_ms']:.2f} / {resumed['device_ms']:.2f} ms, host wall per step "
          f"{first['host_ms']:.2f} / {resumed['host_ms']:.2f} ms, K4 device ms per log event "
          f"{first['k4_ms']} / {resumed['k4_ms']}, peak {first['peak'] / 2 ** 30:.2f} / "
          f"{resumed['peak'] / 2 ** 30:.2f} GiB")
    return first["k4"] + resumed["k4"], n_gen[0]


def phase_vae_step_parity(dev) -> None:
    """One full-width VAE-GAN step (``make_vae_train_step``, batch 2, 640
    frames, ``disc_start`` 0) on the card and on the CPU from the same
    weights, batch and posterior draw."""
    from versband_tpu_torch.cli import train as cli
    from versband_tpu_torch.train.state import make_adam
    from versband_tpu_torch.train.vae_step import make_vae_train_step
    from versband_tpu_torch.utils.config import load_config

    model_cfg = load_config(VAE_CONFIG)["model"]
    model_cfg["params"]["lossconfig"]["params"]["disc_start"] = 0
    lr = 4.5e-6 * VAE_B  # the shipped LR, scaled by the shipped batch
    rng = np.random.RandomState(SEED + 5)
    mel = (rng.randn(2, 80, VAE_T_PAD) * 0.5 - 2.0).astype(np.float32)
    noise = rng.randn(2, model_cfg["params"]["embed_dim"], VAE_T_PAD // 2).astype(np.float32)
    results = []
    for device in (dev, torch.device("cpu")):
        vae, loss = cli.build_vae_gan(model_cfg, device, SEED + 6)
        start = {f"{n}.{k}": v.detach().float().cpu().clone() for n, m in (("gen", vae),
                                                                          ("disc", loss))
                 for k, v in m.named_parameters()}
        gen, disc = TrainState(vae, make_adam(lr)), TrainState(loss, make_adam(lr))
        grads = {}
        for name, state in (("gen", gen), ("disc", disc)):
            apply = state.apply_gradients

            def snapshot_then_apply(state=state, name=name, apply=apply):
                grads.update({f"{name}.{k}": p.grad.detach().float().cpu().clone()
                              for k, p in state.named.items() if p.grad is not None})
                return apply()

            state.apply_gradients = snapshot_then_apply
        n0 = launches() + (fa1.LAUNCHES,)
        m = make_vae_train_step(vae, loss)(gen, disc, {"image": torch.from_numpy(mel).to(device)},
                                           given={"posterior": torch.from_numpy(noise).to(device)})
        after = {f"{n}.{k}": v.detach().float().cpu() for n, mod in (("gen", vae), ("disc", loss))
                 for k, v in mod.named_parameters()}
        if device.type == "cuda":
            torch.cuda.synchronize()
            if launches() + (fa1.LAUNCHES,) != n0:
                raise AssertionError("the VAE-GAN step launched a kernel of K1-K4")
        results.append(({k: float(v) for k, v in m.items()}, grads, start, after))
        del vae, loss, gen, disc
    (m_gpu, g_gpu, s_gpu, a_gpu), (m_cpu, g_cpu, s_cpu, a_cpu) = results
    if set(g_gpu) != set(g_cpu) or any(not torch.equal(s_gpu[k], s_cpu[k]) for k in s_cpu):
        raise AssertionError("card and CPU started from other weights or differ in the "
                             "parameters with a gradient")
    lrel = {k: abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
            for k in ("aeloss", "d_weight", "r1_penalty", "discloss", "rec_loss", "g_loss")}
    big = max(g.abs().max().item() for g in g_cpu.values())
    grel = {k: (g_gpu[k] - g).abs().max().item() / max(g.abs().max().item(),
                                                       STEP_GRAD_FLOOR * big)
            for k, g in g_cpu.items()}
    worst = max(grel, key=grel.get)
    prel, excluded, total = {}, 0, 0
    for k, g in g_cpu.items():
        sure = g.abs() >= VAE_SIGN_FLOOR * max(g.abs().max().item(), STEP_GRAD_FLOOR * big)
        excluded, total = excluded + int((~sure).sum()), total + g.numel()
        d = (a_gpu[k] - a_cpu[k]).abs()[sure]
        prel[k] = d.max().item() / lr if d.numel() else 0.0
    pworst = max(prel, key=prel.get)
    moved = min((a_cpu[k] - s_cpu[k]).abs().max().item() for k in g_cpu)
    print(f"[vae-step] one fp32 VAE-GAN step at full width (ch "
          f"{model_cfg['params']['ddconfig']['ch']}), batch "
          f"2, {VAE_T_PAD} frames, disc_factor {m_cpu['disc_factor']}, card vs CPU: " + ", ".join(
              f"{k} {m_gpu[k]:.6g} vs {m_cpu[k]:.6g} (rel {lrel[k]:.2e})" for k in lrel)
          + f" (tol {VAE_LOSS_TOL:g}); gradients per parameter over its own scale: worst "
          f"{grel[worst]:.2e} ({worst}, tol {STEP_GRAD_TOL:g}); updated parameters: worst "
          f"{prel[pworst]:.2e} x LR ({pworst}, tol {VAE_PARAM_TOL:g}) over the elements whose "
          f"gradient is >= {VAE_SIGN_FLOOR:g} of its parameter's scale ({excluded} of {total} "
          f"elements below it); every parameter moved (min max|d| {moved:.2e})")
    if not (max(lrel.values()) <= VAE_LOSS_TOL and grel[worst] <= STEP_GRAD_TOL
            and prel[pworst] <= VAE_PARAM_TOL and "disc.discriminator.main.3.running_mean"
            in g_cpu):
        raise AssertionError("the VAE-GAN step on the card disagrees with the CPU")


# [voc-train-*]: the vocoders' GAN recipes at full width, fp32
VOC_SEG = 8320  # 26 frames at hop 320: the whole-frame length nearest HiFi-GAN v1's 8,192
HIFIGAN_B, HIFIGAN_STEPS = 16, 5  # HiFi-GAN v1: batch 16, AdamW(2e-4, (0.8, 0.99), 0.01)
HIFIGAN_OPT = dict(learning_rate=2e-4, betas=(0.8, 0.99), weight_decay=0.01)
BIGVGAN_B, BIGVGAN_STEPS = 4, 4  # batch cut from BigVGAN's published 32 for the run's time
MRD_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))
# ParallelWaveGAN v1: batch 6 of 25,600 samples (80 frames + 2 x 2 context
# frames of mel), RAdam 1e-4 / 5e-5 at eps 1e-6, lambda_adv 4; disc_start
# lowered from the shipped 100,000 so that both sides of the gate run
PWG_B, PWG_STEPS, PWG_FRAMES, PWG_CTX, PWG_DISC_START = 6, 4, 80, 2, 2
VOC_T_MEL = 1500  # the 20.0 s mel the trained generators serve
VOC_DIR = Path("build") / "chip_smoke_voc"  # the trained generators' checkpoints
# [voc-step]: one step of each recipe on the card against the CPU's float64
# step, as phase 10 holds the CFM step: the losses relative to themselves,
# each gradient relative to its parameter's largest reference gradient
# (floored at STEP_GRAD_FLOOR x the largest of all). Through cuDNN, whose
# fp32 convolution backward measured 2.4e-3 off float64 on HiFi-GAN's
# stage-2 gradients (see phase_voc_step_parity), the gradient bar is 1e-2.
VOC_STEP_LOSS_TOL, VOC_STEP_GRAD_TOL, VOC_STEP_CUDNN_GRAD_TOL = 1e-4, 1e-3, 1e-2


def voc_audio(dev, B: int, n: int, seed: int) -> torch.Tensor:
    """``[B, n]`` audio-like waveforms made on the device: a sine of 100-500
    Hz per row, its third harmonic and noise, peak under 0.5."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.arange(n, device=dev, dtype=torch.float32) / SR
    f = 100.0 + 400.0 * torch.rand(B, 1, generator=g, device=dev)
    return (0.25 * torch.sin(2 * math.pi * f * t) + 0.08 * torch.sin(6 * math.pi * f * t)
            + 0.05 * torch.randn(B, n, generator=g, device=dev))


class CallRecorder:
    """Wraps ``module.name`` (a kernel's wrapper, as a vocoder module
    imported it) to keep each call's arguments, then puts it back; the
    wrapped function still launches and counts the kernel."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []
        self.fn = getattr(module, name)

    def __enter__(self):
        def record(*args, **kw):
            self.calls.append((args, kw))
            return self.fn(*args, **kw)

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def replay_ms(self) -> float:
        """Mean device time per recorded call: each call timed again by
        ``cuda_ms`` on its own arguments (launches made here are not the main
        path's: read the counts before)."""
        with torch.inference_mode():
            return statistics.mean(cuda_ms(lambda a=a, k=k: self.fn(*a, **k), 3, warmup=1)
                                   for a, k in self.calls)


def _snapshot(module: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def _max_moved(module: torch.nn.Module, before: dict) -> float:
    return max((v.detach() - before[k]).abs().max().item()
               for k, v in module.named_parameters())


def run_voc_recipe(tag: str, step, gstate: TrainState, dstate: TrainState, batches: list,
                   gate: int = None) -> dict:
    """Run ``step`` over ``batches`` with event timing; check finite metrics,
    moved generator and discriminator weights and, with ``gate`` (PWG's
    ``disc_start``), a discriminator unchanged before it and moved after."""
    g0, d0 = _snapshot(gstate.model), _snapshot(dstate.model)
    events, metrics, d_moved = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for batch in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        metrics.append(step(gstate, dstate, batch))
        ev[1].record()
        events.append(ev)
        if gate is not None:  # a host sync per step: only where the gate is checked
            d_moved.append(_max_moved(dstate.model, d0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ms = [a.elapsed_time(b) for a, b in events]
    for i, m in enumerate(metrics):
        vals = {k: v.item() for k, v in m.items()}
        print(f"[{tag}] step {i + 1}: " + ", ".join(f"{k} {x:.5f}" for k, x in vals.items())
              + f"; device {ms[i]:.2f} ms"
              + (f"; discriminator max|d| from start {d_moved[i]:.3e}" if gate is not None
                 else ""))
        if not all(math.isfinite(x) for x in vals.values()):
            raise AssertionError(f"[{tag}] step {i + 1}: non-finite metrics {vals}")
    g_moved, d_end = _max_moved(gstate.model, g0), _max_moved(dstate.model, d0)
    if not (g_moved > 0 and d_end > 0):
        raise AssertionError(f"[{tag}] weights did not move: generator {g_moved}, "
                             f"discriminator {d_end}")
    if gate is not None and not (all(x == 0.0 for x in d_moved[:gate])
                                 and all(x > 0 for x in d_moved[gate:])):
        raise AssertionError(f"[{tag}] the warm-up gate at step {gate}: discriminator moved "
                             f"{d_moved}")
    med = statistics.median(ms[1:])
    n_g = sum(p.numel() for p in gstate.params)
    n_d = sum(p.numel() for p in dstate.params)
    print(f"[{tag}] {len(batches)} steps: generator {n_g / 1e6:.2f} M and discriminators "
          f"{n_d / 1e6:.2f} M parameters moved (max|d| {g_moved:.3e}, {d_end:.3e}); device "
          f"time per step (median of steps 2-{len(batches)}) {med:.2f} ms, "
          f"{1e3 / med:.3f} steps/s; host wall {wall * 1e3:.1f} ms; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated)")
    return {"ms": med, "peak_gib": peak / 2 ** 30}


def _hifigan_batches(dev, mel_fn, B: int, steps: int, seed: int) -> list:
    wavs = voc_audio(dev, B * steps, VOC_SEG, seed).view(steps, B, VOC_SEG)
    return [{"mel": mel_fn(w), "wav": w} for w in wavs]


def _fold_to(gen: torch.nn.Module) -> dict:
    """The serving form's state_dict (weight norm folded) on the host."""
    from versband_tpu_torch.vocoder.conv import fold_weight_norm_

    return {k: v.cpu() for k, v in fold_weight_norm_(copy.deepcopy(gen)).state_dict().items()}


def phase_voc_train_hifigan(dev) -> dict:
    """[voc-train-hifigan]: the HiFi-GAN recipe at full width: ``HifiGanGenerator()``
    trainable, MPD (2, 3, 5, 7, 11) and MSD, the port's ``MelSpectrogram``
    on the card as ``mel_fn``, lambda_fm 2 and lambda_mel 45."""
    from versband_tpu_torch.dsp.mel import MelSpectrogram
    from versband_tpu_torch.train.vocoder_step import make_hifigan_train_step
    from versband_tpu_torch.vocoder.discriminators import (MultiPeriodDiscriminator,
                                                          MultiScaleDiscriminator)

    torch.manual_seed(SEED + 40)
    gen = HifiGanGenerator(use_weight_norm=True).to(dev)
    mpd, msd = MultiPeriodDiscriminator().to(dev), MultiScaleDiscriminator().to(dev)
    mel_fn = MelSpectrogram()
    gstate = TrainState(gen, make_adamw(**HIFIGAN_OPT))
    dstate = TrainState(torch.nn.ModuleDict({"mpd": mpd, "msd": msd}), make_adamw(**HIFIGAN_OPT))
    batches = _hifigan_batches(dev, mel_fn, HIFIGAN_B, HIFIGAN_STEPS, SEED + 41)
    print(f"[voc-train-hifigan] batch {HIFIGAN_B} x {VOC_SEG} samples (mel "
          f"{tuple(batches[0]['mel'].shape)}), AdamW {HIFIGAN_OPT}, fp32")
    return run_voc_recipe("voc-train-hifigan",
                          make_hifigan_train_step(gen, mpd, msd, mel_fn), gstate, dstate,
                          batches)


def _serve_trained(tag: str, voc, trained, mel: torch.Tensor, counter, want: int,
                   recorder: CallRecorder, ref_fn) -> tuple:
    """Vocode ``mel`` through the wrapper with its kernel live (counts reset
    just before, read just after); hold it to the trained unfused generator
    (``ref_fn``) on the card; time both and the kernel per launch."""
    torch.cuda.synchronize()
    reset_launches()  # count only the main path's launches
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode(), recorder:
        ev[0].record()
        out = voc()
        ev[1].record()
    torch.cuda.synchronize()
    n = counter.LAUNCHES
    with torch.inference_mode():
        ev[2].record()
        ref = ref_fn()
        ev[3].record()
    torch.cuda.synchronize()
    err = _max_diff(out, ref)
    k_ms = recorder.replay_ms()
    name = "K4" if counter is fa1 else "K5"
    print(f"[{tag}] served the trained generator from its checkpoint: {mel.shape[-1]} frames -> "
          f"{out.shape[-1]} samples, {n} {name} launches (want {want}); vocode "
          f"{ev[0].elapsed_time(ev[1]):.2f} ms with {name}, the trained unfused generator "
          f"{ev[2].elapsed_time(ev[3]):.2f} ms; max|d| {err:.3e} (tol {MODULE_TOL:g}, phase 7's "
          f"bar for {name} through the generator), |out|max {ref.abs().max():.3f}; {name} "
          f"{k_ms:.3f} ms per launch (each call replayed)")
    if not (n == want and err <= MODULE_TOL and torch.isfinite(out).all()):
        raise AssertionError(f"[{tag}] {n} {name} launches (want {want}), max|d| {err}")
    return n, k_ms


def phase_voc_train_bigvgan(dev) -> dict:
    """[voc-train-bigvgan]: the same recipe with ``BigVGANGenerator()``'s
    geometry, trainable and unfused, MPD and MRD; then the trained generator
    folded, saved as ``g_<step>`` and served through ``build_vocoder`` with
    K4 live."""
    from versband_tpu_torch.dsp.mel import MelSpectrogram
    from versband_tpu_torch.train.vocoder_step import make_hifigan_train_step
    from versband_tpu_torch.vocoder import bigvgan as vb
    from versband_tpu_torch.vocoder.discriminators import (MultiPeriodDiscriminator,
                                                          MultiResolutionDiscriminator)

    torch.manual_seed(SEED + 50)
    gen = BigVGANGenerator(use_fused=False, use_weight_norm=True).to(dev)
    mpd = MultiPeriodDiscriminator().to(dev)
    mrd = MultiResolutionDiscriminator(MRD_RESOLUTIONS).to(dev)
    mel_fn = MelSpectrogram()
    try:
        make_hifigan_train_step(BigVGANGenerator(), mpd, mrd, mel_fn)
    except ValueError as e:
        if "use_fused" not in str(e):
            raise
        print(f"[voc-train-bigvgan] the recipe refuses the use_fused=True generator: {e}")
    else:
        raise AssertionError("[voc-train-bigvgan] the recipe took a generator that launches K4")
    gstate = TrainState(gen, make_adamw(**HIFIGAN_OPT))
    dstate = TrainState(torch.nn.ModuleDict({"mpd": mpd, "mrd": mrd}), make_adamw(**HIFIGAN_OPT))
    batches = _hifigan_batches(dev, mel_fn, BIGVGAN_B, BIGVGAN_STEPS, SEED + 51)
    print(f"[voc-train-bigvgan] batch {BIGVGAN_B} x {VOC_SEG} samples, MRD {MRD_RESOLUTIONS}, "
          f"AdamW {HIFIGAN_OPT}, fp32")
    out = run_voc_recipe("voc-train-bigvgan", make_hifigan_train_step(gen, mpd, mrd, mel_fn),
                         gstate, dstate, batches)

    ckpt = VOC_DIR / "bigvgan"
    ckpt.mkdir(parents=True, exist_ok=True)
    torch.save({"generator": _fold_to(gen)}, ckpt / f"g_{BIGVGAN_STEPS:08d}")
    voc = build_vocoder("bigvgan", str(ckpt), device=dev)
    mel = mel_fn(voc_audio(dev, 1, VOC_T_MEL * HOP, SEED + 52))  # 1500 frames
    gen.eval()
    n, k_ms = _serve_trained("voc-train-bigvgan", lambda: voc.waveform(mel), gen, mel, fa1,
                             K4_PER_CLIP, CallRecorder(vb, "fused_alias_free_snake"),
                             lambda: gen(mel))
    return {**out, "k4": n, "k4_ms": k_ms}


def _pwg_batches(dev, mel_fn, B: int, steps: int, seed: int) -> list:
    """(mel [B, 80, F + 2 ctx], noise, wav [B, F x hop]): the mel of a
    waveform 2 ctx frames longer, the target its middle."""
    n_in, n = (PWG_FRAMES + 2 * PWG_CTX) * HOP, PWG_FRAMES * HOP
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    out = []
    for w in voc_audio(dev, B * steps, n_in, seed).view(steps, B, n_in):
        mel = mel_fn(w)[..., : PWG_FRAMES + 2 * PWG_CTX]
        out.append({"mel": mel, "wav": w[:, PWG_CTX * HOP: PWG_CTX * HOP + n].contiguous(),
                    "noise": torch.randn(B, 1, n, generator=g, device=dev)})
    return out


def phase_voc_train_pwg(dev) -> dict:
    """[voc-train-pwg]: the ParallelWaveGAN recipe at full width (the
    generator's and discriminator's defaults, trainable and unfused, RAdam),
    with the warm-up gate inside the run; then the trained generator saved as
    ``checkpoint-<n>steps.pkl`` and served through ``build_vocoder`` with K5
    live."""
    from versband_tpu_torch.dsp.mel import MelSpectrogram
    from versband_tpu_torch.train.state import make_radam
    from versband_tpu_torch.train.vocoder_step import make_pwg_train_step
    from versband_tpu_torch.vocoder import pwg as vp

    torch.manual_seed(SEED + 60)
    gen = ParallelWaveGANGenerator(use_weight_norm=True).to(dev)
    disc = vp.ParallelWaveGANDiscriminator().to(dev)
    gstate = TrainState(gen, make_radam(1e-4, eps=1e-6))
    dstate = TrainState(disc, make_radam(5e-5, eps=1e-6))
    mel_fn = MelSpectrogram()
    batches = _pwg_batches(dev, mel_fn, PWG_B, PWG_STEPS, SEED + 61)
    print(f"[voc-train-pwg] batch {PWG_B} x {PWG_FRAMES * HOP} samples (mel "
          f"{tuple(batches[0]['mel'].shape)}), RAdam 1e-4 / 5e-5 eps 1e-6, lambda_adv 4, "
          f"disc_start {PWG_DISC_START}, fp32")
    out = run_voc_recipe("voc-train-pwg",
                         make_pwg_train_step(gen, disc, lambda_adv=4.0,
                                             disc_start=PWG_DISC_START),
                         gstate, dstate, batches, gate=PWG_DISC_START)

    ckpt = VOC_DIR / "pwg"
    ckpt.mkdir(parents=True, exist_ok=True)
    torch.save({"model": {"generator": _fold_to(gen)}}, ckpt / f"checkpoint-{PWG_STEPS}steps.pkl")
    voc = build_vocoder("pwg", str(ckpt), device=dev)
    mel = mel_fn(voc_audio(dev, 1, VOC_T_MEL * HOP, SEED + 62))
    voc.generator = torch.Generator(device=dev).manual_seed(SEED + 63)
    w = gen.aux_context_window
    noise = torch.randn((1, 1, mel.shape[-1] * HOP), dtype=torch.float32, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 63))
    gen.eval()
    n, k_ms = _serve_trained("voc-train-pwg", lambda: voc.waveform(mel), gen, mel, fw,
                             K5_PER_CLIP, CallRecorder(vp, "fused_wavenet_layer"),
                             lambda: gen(noise, F.pad(mel, (w, w), mode="replicate"))[:, 0])
    shutil.rmtree(VOC_DIR, ignore_errors=True)
    return {**out, "k5": n, "k5_ms": k_ms}


def _voc_step_grads(step, gstate, dstate, batch) -> tuple:
    """One recipe step; the metrics and each side's gradients as applied."""
    grads = {}
    for tag, state in (("g", gstate), ("d", dstate)):
        apply = state.apply_gradients

        def snapshot_then_apply(tag=tag, state=state, apply=apply):
            grads.update({f"{tag}.{k}": p.grad.detach().double().cpu().clone()
                          for k, p in state.named.items()})
            return apply()

        state.apply_gradients = snapshot_then_apply
    metrics = step(gstate, dstate, batch)
    return {k: v.item() for k, v in metrics.items()}, grads


def phase_voc_step_parity(dev) -> None:
    """[voc-step]: one HiFi-GAN-recipe step and one PWG-recipe step at full
    width (batch 1, 8,320 samples, the PWG gate open) on the card and on the
    CPU from the same weights and batch.

    The CPU computes the step in float64, the reference. The card's fp32
    step is held to it twice: with PyTorch's own CUDA convolutions (cuDNN
    off: the port's function on the card) at the bars of phase 10, and as
    the recipes train, through cuDNN, at VOC_STEP_CUDNN_GRAD_TOL: cuDNN's
    fp32 convolution backward (its default, deterministic and benchmarked
    algorithms alike, ``voc_probe.py grad``) left HiFi-GAN's stage-2
    gradients 2.4e-3 of their scale from float64 on an H100 (the forward
    3.5e-7), where PyTorch's own CUDA convolutions and the CPU's fp32 step
    are 9.1e-4 away."""
    from versband_tpu_torch.dsp.mel import MelSpectrogram
    from versband_tpu_torch.train.state import make_radam
    from versband_tpu_torch.train.vocoder_step import make_hifigan_train_step, make_pwg_train_step
    from versband_tpu_torch.vocoder.conv import apply_weight_norm
    from versband_tpu_torch.vocoder.discriminators import (MultiPeriodDiscriminator,
                                                          MultiScaleDiscriminator)
    from versband_tpu_torch.vocoder.pwg import ParallelWaveGANDiscriminator

    torch.manual_seed(SEED + 70)
    # HiFi-GAN's own init renders a near-silent waveform whose mel sits at the
    # log10 clamp (1e-5), where the mel L1's gradient is 1/(m ln 10): there
    # fp32 on the CPU is 1.1e-3 of conv_post.bias's gradient from float64.
    # Audible weights (N(0, 1/fan_in)) keep the comparison off that clamp.
    hifigan = HifiGanGenerator()
    hifigan.load_state_dict(scaled_conv_weights(hifigan, SEED + 70))
    hifi = (apply_weight_norm(hifigan),
            torch.nn.ModuleDict({"mpd": MultiPeriodDiscriminator(),
                                 "msd": MultiScaleDiscriminator()}))
    pwg = (ParallelWaveGANGenerator(use_weight_norm=True), ParallelWaveGANDiscriminator())
    mel_fn = MelSpectrogram()
    wav = voc_audio(torch.device("cpu"), 1, VOC_SEG + 2 * PWG_CTX * HOP, SEED + 71)
    seg = wav[:, PWG_CTX * HOP: PWG_CTX * HOP + VOC_SEG].contiguous()
    batches = {"hifigan": {"mel": mel_fn(seg), "wav": seg},
               "pwg": {"mel": mel_fn(wav)[..., : VOC_SEG // HOP + 2 * PWG_CTX], "wav": seg,
                       "noise": torch.from_numpy(np.random.RandomState(SEED + 72).randn(
                           1, 1, VOC_SEG).astype(np.float32))}}

    def run(name, device, dtype, cudnn=True):
        gen0, disc0 = hifi if name == "hifigan" else pwg
        gen, disc = copy.deepcopy(gen0).to(device, dtype), copy.deepcopy(disc0).to(device, dtype)
        if name == "hifigan":
            gstate = TrainState(gen, make_adamw(**HIFIGAN_OPT))
            dstate = TrainState(disc, make_adamw(**HIFIGAN_OPT))
            step = make_hifigan_train_step(gen, disc["mpd"], disc["msd"], mel_fn)
        else:
            gstate = TrainState(gen, make_radam(1e-4, eps=1e-6))
            dstate = TrainState(disc, make_radam(5e-5, eps=1e-6))
            step = make_pwg_train_step(gen, disc, lambda_adv=4.0, disc_start=0)
        batch = {k: v.to(device, dtype) for k, v in batches[name].items()}
        t0 = time.perf_counter()
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            out = _voc_step_grads(step, gstate, dstate, batch)
        print(f"[voc-step] {name} on {device.type} ({dtype}, cuDNN {'on' if cudnn else 'off'}): "
              f"{(time.perf_counter() - t0) * 1e3:.0f} ms of host wall")
        return out

    for name in ("hifigan", "pwg"):
        m_ref, g_ref = run(name, torch.device("cpu"), torch.float64)
        big = max(g.abs().max().item() for g in g_ref.values())
        for label, device, cudnn, gtol in (
                ("card, cuDNN off", dev, False, VOC_STEP_GRAD_TOL),
                ("card, cuDNN (as trained)", dev, True, VOC_STEP_CUDNN_GRAD_TOL),
                ("CPU fp32 (not held)", torch.device("cpu"), True, None)):
            m, g = run(name, device, torch.float32, cudnn)
            lerr = max(abs(m[k] - m_ref[k]) / abs(m_ref[k]) for k in m_ref)
            rel = {k: (g[k] - r).abs().max().item()
                   / max(r.abs().max().item(), STEP_GRAD_FLOOR * big) for k, r in g_ref.items()}
            worst = max(rel, key=rel.get)
            print(f"[voc-step] {name} recipe, full width, batch 1 x {VOC_SEG}, {label} (fp32) vs "
                  f"the CPU in float64: losses " + ", ".join(
                      f"{k} {m[k]:.6f}/{m_ref[k]:.6f}" for k in m_ref)
                  + f" (worst rel {lerr:.2e}, tol {VOC_STEP_LOSS_TOL:g}); {len(rel)} gradients, "
                  f"worst max|dgrad| / max(max|grad|, {STEP_GRAD_FLOOR:g} x {big:.3e}) "
                  f"{rel[worst]:.2e} ({worst}, tol {gtol})")
            if gtol is not None and not (set(g) == set(g_ref) and lerr <= VOC_STEP_LOSS_TOL
                                         and rel[worst] <= gtol):
                raise AssertionError(f"[voc-step] the {name} step ({label}) disagrees with the "
                                     f"CPU's float64 step")


# [prep-cli]: 8 synthetic 20 s vocal/accompaniment pairs as a user's songs
# come (44.1 kHz, stereo, int16) and one silent pair, through the port's
# make_manifest -> mel_extract (extract on the card, addmel2tsv) -> the
# vocal_mel_path join that no JAX CLI writes (ROADMAP) -> postprocess, then
# 2 cli.train steps of the shipped YAML from what they wrote. The dataset
# holds out its first 300 rows, so the train manifest directory also holds
# 300 copies of the prepared rows as the held-out set.
PREP_ITEMS, PREP_SEC, PREP_SR = 8, 20.0, 44100
PREP_TEMPLATE = "{root}/{ds}_sp_demix_24k/{sub}/[{idx}]{name}.accomp.wav"
PREP_NOTE_SEC = 0.4  # 30 frames a note at 75 fps: 50 notes fill the 1500 frames
PREP_STEPS = 2
MEL_TOL = 1e-4  # the card's fp32 log-mel against the CPU's (tests/test_torch_port_mel.py's bar)
# [ddp]: cli.train under the torchrun environment at world size 1 (NCCL)
# against the same run without a process group. The CLI's --seed does not
# reach the datasets' crop and caption draws (OS entropy, as in the JAX
# package), so for these two runs each item draws from a generator seeded by
# (SEED, its index), and both runs see the same batches.
DDP_STEPS, DDP_LOSS_TOL = 4, 1e-6


def write_prep_inputs(root: Path, seed: int) -> list:
    """The songs, a prompts TSV, note and beat dicts and a music-feature TSV
    under ``root``; returns the item names (the accompaniment rows')."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    t = np.arange(int(PREP_SEC * PREP_SR)) / PREP_SR
    prompts, names, notes, beats, feats = [], [], {}, {}, []
    for i in range(PREP_ITEMS + 1):
        name = f"crawl<sep>set{i % 2}<sep>song{i}<sep>{i}"
        path = PREP_TEMPLATE.format(root=root, ds="crawl", sub=f"set{i % 2}", idx=i,
                                    name=f"song{i}")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        for stem, path_i in (("accomp", path), ("vocal", path.replace("accomp", "vocal"))):
            freqs = rng.uniform(110.0, 880.0, 3 if stem == "accomp" else 1)
            x = sum(0.15 * np.sin(2 * np.pi * f * t + rng.uniform(0, 6.3)) for f in freqs)
            x = x + 0.02 * rng.standard_normal(t.shape)
            stereo = np.stack([x, 0.8 * x + 0.01 * rng.standard_normal(t.shape)], axis=1)
            if i == PREP_ITEMS:
                stereo = np.zeros_like(stereo)  # silent: extract skips it
            wavfile.write(path_i, PREP_SR, (np.clip(stereo, -1, 1) * 32767).astype(np.int16))
        prompts.append({"item_name": name, "caption": "['piano', 'a calm song with soft drums']"})
        names.append(name)
        n_notes = int(PREP_SEC / PREP_NOTE_SEC)
        notes[name] = {"pitches": rng.integers(40, 90, n_notes),
                       "note_durs": [PREP_NOTE_SEC] * n_notes}
        beats[name] = [[b, 1] for b in np.arange(0.0, PREP_SEC, 0.5)]
        feats.append({"item_name": name, "key": "C major", "key_confidence": 0.9,
                      "tempo": 120, "tempo_confidence": 0.8, "avg_pitch": 64.5,
                      "emotion": "['calm']"})
    write_tsv(str(root / "prompts.tsv"), list(prompts[0]), prompts)
    write_tsv(str(root / "feat.tsv"), list(feats[0]), feats)
    np.save(root / "notes.npy", notes, allow_pickle=True)
    np.save(root / "beats.npy", beats, allow_pickle=True)
    return names[:PREP_ITEMS]


def phase_prep_cli(dev) -> dict:
    """The data-preparation CLIs on the card, then 2 training steps from
    their output (from ``CLI_WORK``: the T5 directory and the VAE of phase
    11). Returns the training run's K1/K2/K3 launches and the mel figures."""
    from versband_tpu_torch.cli import make_manifest, mel_extract, postprocess
    from versband_tpu_torch.data.manifests import read_tsv
    from versband_tpu_torch.dsp.audio_io import load_wav
    from versband_tpu_torch.dsp.loudness import normalize_loudness
    from versband_tpu_torch.dsp.mel import MelSpectrogram

    work = CLI_WORK.resolve()
    root = work / "prep"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    names = write_prep_inputs(root, SEED + 40)
    print(f"[prep-cli] {PREP_ITEMS + 1} pairs of {PREP_SEC:.0f} s stereo int16 wavs at "
          f"{PREP_SR} Hz (the last silent) written in {time.perf_counter() - t0:.1f} s")
    cwd = os.getcwd()
    try:
        os.chdir(root)
        rcs = [make_manifest.main(["--prompts", "prompts.tsv", "--data_root", str(root),
                                   "--out", "music.tsv", "--path_template", PREP_TEMPLATE])]
        listed = len(read_tsv("music.tsv"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rcs.append(mel_extract.main(["--tsv_path", "music.tsv"]))  # on the card
        extract_s = time.perf_counter() - t0
        rcs.append(mel_extract.main(["--tsv_path", "music.tsv", "--mode", "addmel2tsv"]))
        table = read_tsv("music.tsv")
        by_name = {r["name"]: r for r in table.rows}
        joined = [{**r, "vocal_mel_path": by_name[f"{r['name']}vocal"]["mel_path"]}
                  for r in table.rows if f"{r['name']}vocal" in by_name]
        write_tsv("joined.tsv", table.columns + ["vocal_mel_path"], joined)
        rcs.append(postprocess.main(["--manifest", "joined.tsv", "--notes", "notes.npy",
                                     "--beats", "beats.npy", "--music_feat", "feat.tsv",
                                     "--out_dir", "out"]))
        total = read_tsv("out/total.tsv")
        midi = np.load("out/midi.npy", allow_pickle=True).item()
        beats = np.load("out/beats.npy", allow_pickle=True).item()
    finally:
        os.chdir(cwd)
    mels = [np.load(r["mel_path"]) for r in table.rows]
    print(f"[prep-cli] make_manifest listed {listed} rows; extract on the card took "
          f"{extract_s:.2f} s host wall for {listed} clips; addmel2tsv kept {len(table)} and "
          f"dropped {listed - len(table)}; postprocess wrote {len(total)} items "
          f"({len(joined)} joined), midi/beats of {sorted({m.shape for m in midi.values()})}")
    if (any(rcs) or listed != 2 * (PREP_ITEMS + 1) or len(table) != 2 * PREP_ITEMS
            or len(total) != PREP_ITEMS or list(midi) != names or list(beats) != names
            or any(m.shape != (CLI_T_MEL,) or m.dtype != np.int64 for m in midi.values())
            or any(m.shape != (80, CLI_T_MEL) or m.dtype != np.float32
                   or not np.isfinite(m).all() for m in mels)):
        raise AssertionError(f"[prep-cli] rcs {rcs}, rows {listed}/{len(table)}/{len(total)}")

    # one clip's mel as extract computes it: on the card (timed) and on the CPU
    wav, _ = load_wav(table.rows[0]["audio_path"], SR)
    wav = normalize_loudness(wav, -14.0, SR, max_gain_db=20.0)[: int(PREP_SEC * SR)]
    y = torch.from_numpy(np.ascontiguousarray(wav[None], np.float32))
    melnet = MelSpectrogram()
    with torch.no_grad():
        ref = melnet(y)[0].numpy()
        y_dev = y.to(dev)
        times = []
        for _ in range(12):
            ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            ev[0].record()
            out = melnet(y_dev)
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        got = out[0].cpu().numpy()
    d_card = float(np.abs(got - ref).max())
    d_file = float(np.abs(mels[0] - ref).max())
    mel_ms = statistics.median(times[2:])
    print(f"[prep-cli] mel of one {PREP_SEC:.0f} s clip on the card: {mel_ms:.3f} ms (CUDA "
          f"events, median of 10 after 2 warm-up); max|d| against the port's CPU mel "
          f"{d_card:.3e} (the file extract wrote: {d_file:.3e}), bar {MEL_TOL}")
    if not (d_card <= MEL_TOL and d_file <= MEL_TOL):
        raise AssertionError(f"[prep-cli] card mel off the CPU's by {d_card}, file {d_file}")

    train = root / "train"
    train.mkdir()
    write_tsv(str(train / "a_heldout.tsv"), total.columns,
              [total.rows[j % len(total)] for j in range(TRAIN_CLI_VALID)])
    shutil.copy(root / "out" / "total.tsv", train / "b_total.tsv")
    argv = ["-b", str(CLI_CONFIG.resolve()), "-t", "-l", "logs", "-s", str(SEED), "-n", "prep",
            "--max_steps", str(PREP_STEPS), "--max_epochs", str(PREP_STEPS), "--no-test",
            f"data.params.main_spec_dir_path={train}",
            f"data.params.other_condition={root / 'out' / 'midi.npy'}",
            f"model.params.first_stage_config.params.ckpt_path={work / 'vae.pt'}"]
    try:
        os.chdir(work)  # the YAML's relative useful_ckpts/
        run = _train_cli_run(dev, "cli.train from the prepared manifest", argv, PREP_STEPS,
                             phase="prep-cli")
    finally:
        os.chdir(cwd)
    return {"launches": run["launches"], "mel_ms": mel_ms, "mel_err": d_card,
            "kept": len(table), "dropped": listed - len(table)}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_ddp(dev) -> dict:
    """Data-parallel training at world size 1 on the card (from ``CLI_WORK``
    as phase 12 left it): cli.train in this process under the torchrun
    environment (NCCL) against the same run without a process group; cli.train
    under ``torch.distributed.run``; ``--devices`` above the host's cards
    (2 on one card) raises.
    Returns the in-process runs' K1/K2/K3 launches and the all-reduce
    figures."""
    from versband_tpu_torch import parallel
    from versband_tpu_torch.cli import train as cli
    from versband_tpu_torch.data.vocal2accomp import JoinManifestSpecs
    from versband_tpu_torch.train.state import TrainState

    work = CLI_WORK.resolve()
    data = work / "train_data"  # phase 12's manifest: 300 held out, 16 train rows
    base = ["-b", str(CLI_CONFIG.resolve()), "-t", "-l", "logs", "-s", str(SEED), "--no-test",
            f"data.params.main_spec_dir_path={data / 'manifests'}",
            f"data.params.other_condition={data / 'midi.npy'}",
            f"model.params.first_stage_config.params.ckpt_path={work / 'vae.pt'}"]
    steps = ["--max_steps", str(DDP_STEPS), "--max_epochs", "2"]
    env = dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    reduce_calls = []
    real_reduce = TrainState.reduce_gradients

    def timed_reduce(state):
        ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
        ev[0].record()
        real_reduce(state)
        ev[1].record()
        reduce_calls.append((ev, sum(p.numel() * p.element_size() for p in state.params)))

    # the datasets' draws are not seeded by --seed (ROADMAP Queue 3): each
    # item's stream restarts from [SEED, index], so the two runs see one batch
    real_item = JoinManifestSpecs.__getitem__

    def seeded_item(ds, idx):
        ds.rng.reseed([SEED, int(idx)])  # the item's draws whatever thread serves it
        return real_item(ds, idx)

    cwd = os.getcwd()
    try:
        os.chdir(work)
        JoinManifestSpecs.__getitem__ = seeded_item
        plain = _train_cli_run(dev, "no process group", base + steps + ["-n", "ddp_plain"],
                               DDP_STEPS, phase="ddp")
        os.environ.update(env)
        TrainState.reduce_gradients = timed_reduce
        nccl = _train_cli_run(dev, "torchrun environment, NCCL, world size 1",
                              base + steps + ["-n", "ddp_nccl"], DDP_STEPS, phase="ddp")
    finally:
        JoinManifestSpecs.__getitem__ = real_item
        TrainState.reduce_gradients = real_reduce
        for k in env:
            os.environ.pop(k, None)
        os.chdir(cwd)
    if parallel.active():
        raise AssertionError("[ddp] cli.train left its process group behind")
    loss = [torch.cat([m["loss"].reshape(-1).double().cpu() for m in r["probe"].metrics])
            for r in (plain, nccl)]
    diff = float((loss[0] - loss[1]).abs().max())
    torch.cuda.synchronize()
    ar_ms = [ev[0].elapsed_time(ev[1]) for ev, _ in reduce_calls]
    nbytes = reduce_calls[0][1] if reduce_calls else 0
    print(f"[ddp] losses per step without a group {loss[0].tolist()}, under NCCL at world size "
          f"1 {loss[1].tolist()}: max|d| {diff:.3e} (bar {DDP_LOSS_TOL}); the DiT's gradient "
          f"all-reduce: {nbytes} bytes in one buffer, {statistics.median(ar_ms):.3f} ms a step "
          f"(CUDA events, median of {len(ar_ms)}: {['%.3f' % x for x in ar_ms]})")
    if len(ar_ms) != DDP_STEPS or not diff <= DDP_LOSS_TOL * max(1.0, float(loss[0].abs().max())):
        raise AssertionError(f"[ddp] losses off by {diff} or {len(ar_ms)} all-reduces")

    # a torchrun launch of the CLI, as a user runs it
    argv = base + ["--max_steps", "2", "--max_epochs", "1", "-n", "torchrun"]
    repo = str(Path(__file__).resolve().parent)
    sub_env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "1", "-m", "versband_tpu_torch.cli.train",
                           *argv], cwd=work, env=sub_env, capture_output=True, text=True,
                          timeout=600)
    sub_s = time.perf_counter() - t0
    logdirs = sorted((work / "logs").glob("*_torchrun"))
    ckpts = sorted(p.name for d in logdirs for p in (d / "checkpoints").iterdir()) \
        if logdirs else []
    meta = json.loads((logdirs[0] / "checkpoints" / "last_step.json").read_text()) \
        if len(logdirs) == 1 and "last_step.json" in ckpts else {}
    lr_lines = [line for line in proc.stdout.splitlines() if "learning rate" in line]
    print(f"[ddp] torch.distributed.run --standalone --nproc_per_node 1 -m "
          f"versband_tpu_torch.cli.train: exit {proc.returncode} in {sub_s:.1f} s; run "
          f"directories {[d.name for d in logdirs]}, checkpoints {ckpts}, last_step.json "
          f"{meta}; {lr_lines}")
    if proc.returncode != 0 or len(logdirs) != 1 or ckpts.count("last.pt") != 1 \
            or meta.get("step") != 2:
        raise AssertionError(f"[ddp] torchrun run failed:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")

    n_cards = torch.cuda.device_count()  # one: --devices 2
    try:
        cli.main(["-b", str(CLI_CONFIG.resolve()), "-t", "--devices", str(n_cards + 1)])
    except ValueError as e:
        print(f"[ddp] --devices {n_cards + 1} on this host raises: {e}")
        if f"({n_cards})" not in str(e) or f"--devices {n_cards + 1}" not in str(e):
            raise
    else:
        raise AssertionError(f"[ddp] --devices {n_cards + 1} on {n_cards} card(s) did not raise")
    counts = [plain["launches"], nccl["launches"]]
    return {"launches": tuple(sum(c[i] for c in counts) for i in range(3)),
            "allreduce_ms": statistics.median(ar_ms), "allreduce_bytes": nbytes,
            "loss_diff": diff}


# [audioldm]: AudioLDM's best-of-N generation over the shipped DiT
# (configs/vocal2music.yaml's model.params, target swapped), reranked by CLAP at
# its published geometry (text/clap.py's Cnn14 defaults, bert-base-uncased's
# config.json), fp32 with TF32 off.
LDM_TARGET = "ldm.models.diffusion.audioldm.LatentDiffusion"
LDM_N, LDM_DDIM_S, LDM_PLMS_S, LDM_ETA, LDM_SCALE = 3, 200, 50, 1.0, 2.0
# the ancestral loop's timesteps: the schedule's 1000 took 20.87 s at 20.82 ms a
# step (H100/700 W), past the phase's ~20 s for it, so half of them over the
# same linear range
LDM_ANCESTRAL_T = 500
LDM_PARITY_S, LDM_PARITY_T_MEL = 5, 256  # card against CPU: 5 steps over 5.3 s of mel
BERT_DIR = Path("build") / "chip_smoke_bert"
BERT_BASE_UNCASED = dict(model_type="bert", hidden_size=768, num_hidden_layers=12,
                         num_attention_heads=12, intermediate_size=3072, vocab_size=30522,
                         max_position_embeddings=512, type_vocab_size=2, hidden_act="gelu",
                         layer_norm_eps=1e-12, pad_token_id=0)
LDM_CAPTIONS = ["Style: pop ballad with piano Musical: a calm melody in C major"]


def write_wordpiece_json(path: Path, words, pinned: dict = None) -> None:
    """A bert-base-uncased style ``tokenizer.json`` written by hand: [PAD] 0,
    [unused0-98] 1-99, [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103
    (bert-base-uncased's ids), then each character seen with its ``##`` form
    and each lowercased word; each ``pinned`` token at its own id (``|`` is
    1064 in bert-base-uncased), ``[unused<n>]`` filling the gap below it;
    BertNormalizer (lowercase), BertPreTokenizer, ``[CLS] $A [SEP]``."""
    pinned = dict(pinned or {})
    words = sorted({w.lower() for w in words if w} - set(pinned))
    chars = sorted({c for w in words for c in w} | set("0123456789.,:;!?'-") - set(pinned))
    toks = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                              "[MASK]"]
    seen = set(toks)
    for tok in chars + ["##" + c for c in chars] + words:
        if tok not in seen:
            toks.append(tok)
            seen.add(tok)
    for tok, i in sorted(pinned.items(), key=lambda kv: kv[1]):
        while len(toks) < i:
            toks.append(f"[unused{len(toks)}]")
        toks.insert(i, tok)
    vocab = {t: i for i, t in enumerate(toks)}
    special = [{"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
                "rstrip": False, "normalized": False, "special": True}
               for t in ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")]
    doc = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": special,
           "normalizer": {"type": "BertNormalizer", "clean_text": True,
                          "handle_chinese_chars": True, "strip_accents": None,
                          "lowercase": True},
           "pre_tokenizer": {"type": "BertPreTokenizer"},
           "post_processor": {"type": "TemplateProcessing",
                              "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                                         {"Sequence": {"id": "A", "type_id": 0}},
                                         {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
                              "pair": [],
                              "special_tokens": {t: {"id": t, "ids": [vocab[t]], "tokens": [t]}
                                                 for t in ("[CLS]", "[SEP]")}},
           "model": {"type": "WordPiece", "unk_token": "[UNK]",
                     "continuing_subword_prefix": "##", "max_input_chars_per_word": 100,
                     "vocab": vocab}}
    path.write_text(json.dumps(doc, ensure_ascii=False))


def write_bert_dir(path: Path, config: dict, seed: int) -> None:
    """A Hugging Face BERT directory: ``config.json``, random weights (BERT's
    init from ``seed``) as ``model.safetensors``, and a WordPiece
    ``tokenizer.json`` over :func:`caption_words` and the captions of
    ``[audioldm]`` and ``[concat-order]``, ``|`` at its bert-base-uncased id."""
    from versband_tpu_torch.text.bert import BertModel, save_bert_dir

    save_bert_dir(BertModel(config).init_weights(torch.Generator().manual_seed(seed)), str(path))
    write_wordpiece_json(path / "tokenizer.json",
                         caption_words() + LDM_CAPTIONS[0].split() + " ".join(ORDER_CAPTIONS).split(),
                         pinned={"|": ORDER_SEP_ID})


@torch.no_grad()
def build_audioldm(dev):
    """AudioLDM through the resolver from the shipped YAML's model.params
    (target swapped; the VAE's ckpt_path and the caption tower dropped: the
    weights are random from SEED and the conditioning comes encoded), the
    DiT's adaLN-zero layers perturbed; HiFi-GAN as ``build_vocoder`` builds
    it; CLAP over :data:`BERT_DIR`, its conv weights N(0, 2/fan_in) so
    activations keep their size through Cnn14's ReLUs."""
    from versband_tpu_torch.text.clap import CLAP
    from versband_tpu_torch.utils.config import instantiate_from_config, load_config

    params = copy.deepcopy(dict(load_config(str(CLI_CONFIG)).model.params))
    params["first_stage_config"]["params"].pop("ckpt_path", None)
    params["cond_stage_config"] = None
    torch.manual_seed(SEED)
    ldm = instantiate_from_config({"target": LDM_TARGET, "params": params}, device=dev,
                                  dtype=torch.float32)
    perturb_zero_init(ldm.model, SEED)
    voc = build_vocoder("hifigan", device=dev)
    if not BERT_DIR.exists():
        write_bert_dir(BERT_DIR, BERT_BASE_UNCASED, SEED + 40)
    clap = CLAP(text_model=str(BERT_DIR), device=dev, seed=SEED + 41)
    g = torch.Generator().manual_seed(SEED + 42)
    for p in clap.audio_encoder.parameters():  # He-scaled convs: Cnn14's 12 ReLU layers
        if p.ndim == 4:
            p.copy_((torch.randn(p.shape, generator=g) * math.sqrt(2 / p[0].numel())).to(dev))
    return ldm, voc, clap


def ldm_context(dev, t_mel: int, seed: int) -> tuple:
    """([serve]'s) conditioning and the unconditional branch as DiT contexts:
    caption [1, 80, 1024], midi and beats of ``t_mel`` frames."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cond = {"c_crossattn": torch.randn(1, 80, 1024, generator=gen, device=dev),
            "c_concat": {"midi": torch.randint(0, 128, (1, 1, t_mel), generator=gen, device=dev),
                         "beats": torch.randint(0, 2, (1, 1, t_mel), generator=gen,
                                                device=dev)}}
    uncond = {"c_crossattn": torch.zeros(1, 80, 1024, device=dev),
              "c_concat": {"midi": torch.full((1, 1, t_mel), 128, device=dev),
                           "beats": torch.full((1, 1, t_mel), 2, device=dev)}}
    return cond, uncond


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@torch.no_grad()
def phase_audioldm_parity(ldm, voc, clap, dev) -> None:
    """Card against CPU at a cut length and step count, same weights and
    draws: DDIM and PLMS latents, the candidates' CLAP audio embeddings, the
    BERT hidden states and the rerank's chosen rows."""
    from versband_tpu_torch.models.samplers import PLMSSampler

    cpu = copy.deepcopy(ldm)
    cpu.device = torch.device("cpu")
    cpu.model, cpu.first_stage = cpu.model.cpu(), cpu.first_stage.cpu()
    cpu_voc, cpu_clap = copy.deepcopy(voc.model).cpu(), copy.deepcopy(clap).cpu()
    cpu_clap.device = torch.device("cpu")
    t_lat = LDM_PARITY_T_MEL // 2
    cond, uncond = ldm_context(torch.device("cpu"), LDM_PARITY_T_MEL, SEED + 50)
    shape = (LDM_N, 20, t_lat)
    g = torch.Generator().manual_seed(SEED + 51)
    x_T = torch.randn(shape, generator=g)
    draws = [torch.randn(shape, generator=g) for _ in range(LDM_PARITY_S)]
    out = {}
    for side, m, vf, c, d in (("card", ldm, voc.waveform, clap, dev),
                              ("cpu", cpu, cpu_voc, cpu_clap, torch.device("cpu"))):
        trace = {}
        m.generate_batch(_to(cond, d), LDM_CAPTIONS, vf, c, uncond=_to(uncond, d),
                         guidance_scale=LDM_SCALE, n_candidates=LDM_N, ddim_steps=LDM_PARITY_S,
                         eta=LDM_ETA, shape=(1, 20, t_lat), x_T=x_T.to(d),
                         noise=lambda i, d=d: draws[i].to(d), trace=trace)
        ctx = {k: _tree_tile(v, LDM_N) for k, v in _to(cond, d).items()}
        uctx = {k: _tree_tile(v, LDM_N) for k, v in _to(uncond, d).items()}
        plms = PLMSSampler(lambda x, t, cc, m=m: m.model(x, t, cc), m.schedule).sample(
            shape, ctx, S=LDM_PARITY_S, unconditional_guidance_scale=LDM_SCALE,
            unconditional_conditioning=uctx, x_T=x_T.to(d))
        ids = torch.from_numpy(np.asarray(c.tokenize(LDM_CAPTIONS), np.int64)).to(d)
        out[side] = dict(ddim=trace["samples"], plms=plms, audio=trace["audio_emb"],
                         bert=c.caption_encoder.base(ids), best=trace["best_index"],
                         sims=trace["sims"])
    for key in ("ddim", "plms", "audio", "bert"):
        a, b = out["card"][key], out["cpu"][key]
        err = _max_diff(a, b)
        print(f"[audioldm] card vs CPU {key} {tuple(b.shape)} fp32 (S {LDM_PARITY_S}, T_mel "
              f"{LDM_PARITY_T_MEL}): max|d| {err:.3e} (tol {MODULE_TOL:g}), "
              f"|cpu|max {b.abs().max():.3f}")
        if not (err <= MODULE_TOL and torch.isfinite(a).all()):
            raise AssertionError(f"[audioldm] {key} on the card disagrees with the CPU: {err}")
    sims = out["cpu"]["sims"][:, 0]
    top = np.sort(sims)[::-1]
    sims_err = np.abs(out["card"]["sims"] - out["cpu"]["sims"]).max()
    print(f"[audioldm] rerank rows card {out['card']['best']} cpu {out['cpu']['best']}; CPU "
          f"similarities {np.round(sims, 5).tolist()} (margin of the best "
          f"{top[0] - top[1]:.3e}), max|d| of the similarities {sims_err:.3e}")
    if out["card"]["best"] != out["cpu"]["best"]:
        raise AssertionError(f"[audioldm] the rerank picked {out['card']['best']} on the card, "
                             f"{out['cpu']['best']} on the CPU")


def _tree_tile(c, n: int):
    if isinstance(c, dict):
        return {k: _tree_tile(v, n) for k, v in c.items()}
    return torch.cat([c] * n, dim=0)


@torch.no_grad()
def phase_audioldm(dev) -> dict:
    """[audioldm]: ``AudioLDM.generate_batch`` (DDIM S 200, eta 1, CFG 2.0, 3
    candidates; then PLMS S 50) and ``ddpm_sample_loop`` (B 1, no CFG) at full
    width, with exact K1 launch counts; K1 at the new shape against its plain
    version; card against CPU; timings."""
    from versband_tpu_torch.models.samplers import ddpm_sample_loop
    from versband_tpu_torch.models.schedules import DiffusionSchedule

    t0 = time.perf_counter()
    ldm, voc, clap = build_audioldm(dev)
    print(f"[audioldm] built {type(ldm).__name__} from {CLI_CONFIG} with target {LDM_TARGET} "
          f"(DiT {sum(p.numel() for p in ldm.model.parameters()) / 1e6:.1f} M, VAE, "
          f"{ldm.num_timesteps} timesteps linear {ldm.schedule.betas[0]:.5f}-"
          f"{ldm.schedule.betas[-1]:.5f}), HiFi-GAN, CLAP (Cnn14 "
          f"{sum(p.numel() for p in clap.audio_encoder.parameters()) / 1e6:.1f} M, BERT "
          f"{sum(p.numel() for p in clap.caption_encoder.base.parameters()) / 1e6:.1f} M from "
          f"{BERT_DIR}) in {time.perf_counter() - t0:.1f} s")
    cond, uncond = ldm_context(dev, T_MEL, SEED + 10)
    counts, res = {}, {}
    n = T_MEL * HOP
    for name, plms, S in (("ddim", False, LDM_DDIM_S), ("plms", True, LDM_PLMS_S)):
        events, trace = [], {}
        model = ldm.model
        ldm.model = _CallThrough(model, events)
        gen = torch.Generator(device=dev).manual_seed(SEED + 60)
        torch.cuda.synchronize()
        reset_launches()  # count only the main path's launches
        t1 = time.perf_counter()
        wav = ldm.generate_batch(cond, LDM_CAPTIONS, voc.waveform, clap, gen, uncond=uncond,
                                 guidance_scale=LDM_SCALE, n_candidates=LDM_N, ddim_steps=S,
                                 eta=LDM_ETA, use_plms=plms, shape=(1, 20, T_LAT), trace=trace)
        wall = time.perf_counter() - t1
        counts[name] = fa.LAUNCHES
        ldm.model = model
        calls = len(events)
        want_calls = S + int(plms)
        if calls != want_calls or counts[name] != DIT["depth"] * want_calls:
            raise AssertionError(f"[audioldm] {name}: {calls} model calls, {counts[name]} K1 "
                                 f"launches; expected {want_calls} and "
                                 f"{DIT['depth'] * want_calls}")
        w = trace["waveform"]
        if tuple(w.shape) != (LDM_N, n) or not torch.isfinite(w).all() or not w.std() > 0:
            raise AssertionError(f"[audioldm] {name}: candidates {tuple(w.shape)}, finite "
                                 f"{bool(torch.isfinite(w).all())}")
        if wav.shape != (1, n) or not np.isfinite(wav).all():
            raise AssertionError(f"[audioldm] {name}: the chosen waveform {wav.shape}")
        step_ms = events[0].elapsed_time(events[-1]) / (calls - 1)
        res[name] = dict(step_ms=step_ms, wall=wall, best=trace["best_index"])
        print(f"[audioldm] {name} S {S}: {calls} DiT calls at batch {2 * LDM_N} (CFG), K1 "
              f"launches {counts[name]} (= 4 x {want_calls}); {step_ms:.2f} ms per step (device, "
              f"between the calls' ends); generate_batch host wall {wall * 1e3:.1f} ms; "
              f"candidates {tuple(w.shape)} finite, chosen row {trace['best_index']}, "
              f"similarities {np.round(trace['sims'][:, 0], 4).tolist()}")

    # the ancestral loop, B 1 without CFG
    sched = ldm.schedule if LDM_ANCESTRAL_T == ldm.num_timesteps else DiffusionSchedule.create(
        LDM_ANCESTRAL_T, "linear", 0.00085, 0.012)
    if LDM_ANCESTRAL_T != ldm.num_timesteps:
        print(f"[audioldm] ancestral loop cut to {LDM_ANCESTRAL_T} of {ldm.num_timesteps} "
              f"timesteps (the same linear range)")
    events = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    z = ddpm_sample_loop(_CallThrough(ldm.model, events), sched, (1, 20, T_LAT), cond, gen,
                         device=dev)
    torch.cuda.synchronize()
    anc_wall = time.perf_counter() - t1
    counts["ancestral"] = fa.LAUNCHES
    if counts["ancestral"] != DIT["depth"] * LDM_ANCESTRAL_T or not torch.isfinite(z).all():
        raise AssertionError(f"[audioldm] ancestral: {counts['ancestral']} K1 launches "
                             f"(expected {DIT['depth'] * LDM_ANCESTRAL_T}), finite "
                             f"{bool(torch.isfinite(z).all())}")
    anc_ms = events[0].elapsed_time(events[-1]) / (len(events) - 1)
    print(f"[audioldm] ancestral T {LDM_ANCESTRAL_T} at B 1: K1 launches {counts['ancestral']} "
          f"(= 4 x {LDM_ANCESTRAL_T}); {anc_ms:.2f} ms per step (device); host wall "
          f"{anc_wall:.2f} s; latents {tuple(z.shape)} finite, |z|max {z.abs().max():.3f}")

    # the rerank's parts, timed on the card
    wav3 = torch.randn(LDM_N, n, generator=torch.Generator(device=dev).manual_seed(SEED + 62),
                       device=dev) * 0.1
    cnn_ms = cuda_ms(lambda: clap.audio_encoder(wav3), 5) / LDM_N
    ids = torch.from_numpy(np.asarray(clap.tokenize(LDM_CAPTIONS), np.int64)).to(dev)
    bert_ms = cuda_ms(lambda: clap.caption_encoder.base(ids), 20)
    rerank_ms = LDM_N * cnn_ms + bert_ms
    print(f"[audioldm] CLAP: Cnn14 {cnn_ms:.2f} ms per 20 s candidate, BERT "
          f"{tuple(ids.shape)} {bert_ms:.2f} ms per call (device); the rerank ~{rerank_ms:.1f} ms "
          f"is {rerank_ms / (res['ddim']['wall'] * 1e3):.2%} of DDIM's generate_batch wall and "
          f"{rerank_ms / (res['plms']['wall'] * 1e3):.2%} of PLMS's")

    # K1 at the new shape: DDIM/PLMS with CFG over 3 candidates, fp32
    g = torch.Generator(device=dev).manual_seed(SEED + 63)
    q, k, v = (torch.randn(2 * LDM_N, T_LAT, 8, 96, generator=g, device=dev) for _ in range(3))
    got, _ = fa.flash_attention_fwd(q, k, v)
    ref, _ = fa._reference_fwd(q, k, v, None, 1.0 / math.sqrt(96))
    err = _max_diff(got, ref)
    if not err <= K1_TOL[torch.float32]:
        raise AssertionError(f"[audioldm] K1 at q{tuple(q.shape)} fp32 disagrees: {err}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 50)
    plain = cuda_ms(lambda: fa.flash_attention_reference(q, k, v), 10)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 50)
    bound, by = k1_bound_ms(q, k, v, None)
    print(f"[audioldm] K1 q{tuple(q.shape)} fp32: max|kernel-plain| {err:.3e} (tol "
          f"{K1_TOL[torch.float32]:g}); kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"scaled_dot_product_attention {lib:.4f} ms, bound {bound:.4f} ms ({by}), kernel at "
          f"{bound / ms:.1%} of bound")

    phase_audioldm_parity(ldm, voc, clap, dev)
    shutil.rmtree(BERT_DIR, ignore_errors=True)
    print(f"[audioldm] phase wall {time.perf_counter() - t0:.1f} s")
    return {"k1": sum(counts.values())}


# [timefreq-cli], [concat-order], [ae2d], [legacy-modules]: the legacy
# backbones and the 2-D first stage, fp32 with TF32 off, random weights from
# SEED, at the published widths and full depth.
# The reference's VideoFlagLargeDiT defaults (TimeFreqMoeDiT's), with the
# latent and T5 widths of configs/vocal2music.yaml.
TIMEFREQ_TARGET = "ldm.modules.diffusionmodules.flag_large_dit_moe.VideoFlagLargeDiT"
TIMEFREQ = dict(in_channels=20, context_dim=1024, hidden_size=1152, depth=28, num_heads=16,
                num_experts=8, multiple_of=256, max_len=1000)
TIMEFREQ_SCALE = "2"
TIMEFREQ_BIGVGAN = Path("useful_ckpts") / "bigvgan_scaled"  # under CLI_WORK
# ddpm_audio_order's LDM over ConcatOrderDiT at its class defaults, BERT-width
# caption tokens, the shipped 1-D VAE
ORDER_LDM_TARGET = "ldm.models.diffusion.ddpm_audio_order.LatentDiffusion_audio"
CONCAT_ORDER = dict(in_channels=20, context_dim=768, hidden_size=1152, depth=28, num_heads=16,
                    max_len=1000, num_orders=100)
ORDER_CAPTIONS = ["piano | bass | drums", "acoustic guitar | strings | drums | synth pad"]
ORDER_SEP_ID = 1064  # '|' in bert-base-uncased
ORDER_TC, ORDER_MAX_OBJS, ORDER_DDIM_S = 64, 10, 25
# AudioLDM's first stage (audioldm/utils.py::default_audioldm_config): 64 mel
# bins x 1024 frames, as a 1-channel image
AE2D = dict(embed_dim=8, ddconfig=dict(double_z=True, z_channels=8, resolution=256,
                                       in_channels=1, out_ch=1, ch=128, ch_mult=[1, 2, 4],
                                       num_res_blocks=2, attn_resolutions=[]))
AE2D_SHAPE = (2, 1, 1024, 64)


def perturb_zeros(model: torch.nn.Module, seed: int, std: float = 0.02) -> int:
    """Every all-zero parameter (adaLN-zero layers, attention gates, the zero
    output projections) drawn N(0, std), so that each block counts; returns
    how many elements were drawn."""
    g, n = torch.Generator().manual_seed(seed), 0
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_((torch.randn(p.shape, generator=g) * std).to(p.device, p.dtype))
                n += p.numel()
    return n


def timefreq_flops(B: int, T: int, Ty: int, cfg: dict) -> float:
    """FLOPs of one TimeFreqMoeDiT forward: per block the q/k/v/o and caption
    k/v projections, self and cross attention, the dense time and frequency
    experts (E x 3 SwiGLU products each) and adaLN; proj_in, the final layer
    and the caption embedder once."""
    from versband_tpu_torch.nn.core import swiglu_hidden_dim

    H, E, C = cfg["hidden_size"], cfg["num_experts"], cfg["in_channels"]
    h = swiglu_hidden_dim(4 * H, cfg["multiple_of"])
    block = (2 * B * T * 4 * H * H + 2 * B * Ty * 2 * H * H + 4 * B * T * (T + Ty) * H
             + 2 * E * 3 * 2 * B * T * H * h + 2 * B * 6 * H * H)
    return cfg["depth"] * block + 2 * B * T * C * H * 2 + 2 * B * Ty * (cfg["context_dim"] + H) * H


def concat_flops(B: int, T: int, Tc: int, cfg: dict) -> float:
    """FLOPs of one ConcatOrderDiT forward over L = 1 + Tc + T tokens: per
    block the 1x1 convs, two attentions (4 projections and the products each)
    and the k9 GEGLU convs (8H and 4H channels out of H and 4H: 108 H^2 per
    token); proj_in (k5), the caption embedder and the head once."""
    H, C, L = cfg["hidden_size"], cfg["in_channels"], 1 + Tc + T
    block = 2 * B * L * (2 + 8 + 108) * H * H + 2 * 4 * B * L * L * H
    return (cfg["depth"] * block + 2 * B * T * 5 * C * H + 2 * B * Tc * (cfg["context_dim"] + H) * H
            + 2 * B * T * H * C)


def phase_timefreq_cli(dev) -> int:
    """[timefreq-cli]: ``cli.generate.main`` on configs/vocal2music.yaml with
    its ``unet_config`` replaced by ``VideoFlagLargeDiT`` at the published
    widths, from ``CLI_WORK`` as phase 11 left it (the T5 directory, the VAE,
    the manifest), 1 item at ``--scales 2`` vocoded by BigVGAN; returns its K4
    launches (73; K1 none: the attention is plain, as in JAX), the sampler's
    ms and TFLOP/s a step and the parameter count."""
    from versband_tpu_torch.cli import generate as cli
    from versband_tpu_torch.models import cfm as cfm_mod
    from versband_tpu_torch.models.dit_timefreq import TimeFreqMoeDiT
    from versband_tpu_torch.utils.config import config_to_yaml, load_config
    from versband_tpu_torch.utils.misc import count_params

    root = CLI_WORK.resolve()
    t0 = time.perf_counter()
    cfg = load_config(str(CLI_CONFIG))
    cfg["model"]["params"]["unet_config"] = {"target": TIMEFREQ_TARGET, "params": dict(TIMEFREQ)}
    (root / "timefreq.yaml").write_text(config_to_yaml(cfg))
    with torch.device("meta"):  # shapes only
        meta = TimeFreqMoeDiT(**TIMEFREQ)
    n_params = count_params(meta)
    # the adaLN-zero layers, the final layer and the gates, drawn from SEED:
    # the rest of the weights the CLI initialises from --seed
    g = torch.Generator().manual_seed(SEED + 70)
    part = {k: torch.randn(p.shape, generator=g) * 0.02 for k, p in meta.named_parameters()
            if "adaLN" in k or "final_layer" in k or k.endswith("gate")}
    torch.save(part, root / "timefreq_dit.pt")
    (root / TIMEFREQ_BIGVGAN).mkdir(parents=True, exist_ok=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 71)
        torch.save({"generator": scaled_conv_weights(BigVGANGenerator(), SEED + 71)},
                   root / TIMEFREQ_BIGVGAN / "g_00000001")
    print(f"[timefreq-cli] {TIMEFREQ_TARGET} {TIMEFREQ}: {n_params / 1e9:.3f} B parameters "
          f"(count_params), {n_params * 4 / 1e9:.2f} GB in fp32; its zero-init layers "
          f"({count_params(part) / 1e6:.1f} M) and a BigVGAN written in "
          f"{time.perf_counter() - t0:.1f} s")
    del meta, part

    builds, shapes = [], []
    build, fwd = cfm_mod.LatentDiffusion._build, TimeFreqMoeDiT.forward

    def timed_build(self, config):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = build(self, config)
        torch.cuda.synchronize()
        builds.append((type(m).__name__, time.perf_counter() - t))
        return m

    def seen_forward(self, x, t, context, *a, **k):
        ctx = context.get("c_crossattn", context) if isinstance(context, dict) else context
        shapes.append((tuple(x.shape), tuple(ctx.shape)))
        return fwd(self, x, t, context, *a, **k)

    argv = ["--config", str(root / "timefreq.yaml"), "--ckpt", str(root / "timefreq_dit.pt"),
            "--vae_ckpt", str(root / "vae.pt"), "--vocoder", "bigvgan",
            "--vocoder_ckpt", str(root / TIMEFREQ_BIGVGAN), "--manifest",
            str(root / "manifest"), "--other_condition", str(root / "midi.npy"),
            "--scales", TIMEFREQ_SCALE, "--num_items", "1", "--seed", str(SEED),
            "--save_dir", "out_timefreq"]
    cwd, stats = os.getcwd(), []
    cfm_mod.LatentDiffusion._build, TimeFreqMoeDiT.forward = timed_build, seen_forward
    try:
        os.chdir(root)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # count only this path's launches
        t0 = time.perf_counter()
        rc = cli.main(argv, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k4, k5 = fa.LAUNCHES, fa1.LAUNCHES, fw.LAUNCHES
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        os.chdir(cwd)
        cfm_mod.LatentDiffusion._build, TimeFreqMoeDiT.forward = build, fwd
    print(f"[timefreq-cli] main() returned {rc} in {wall:.2f} s host wall (builds, checkpoint "
          f"loads, T5 and BigVGAN included); built on {dev}: "
          + ", ".join(f"{n} {s:.2f} s" for n, s in builds)
          + f"; peak memory {peak:.2f} GiB; launches K1 {k1}, K4 {k4} (want {K4_PER_CLIP}), "
            f"K5 {k5}")
    if rc != 0 or k1 or k5 or k4 != K4_PER_CLIP:
        raise AssertionError(f"[timefreq-cli] rc {rc}, launches K1 {k1}, K4 {k4}, K5 {k5}")
    (B, _, T), (_, Ty, _) = shapes[0]
    if len(shapes) != STEPS - 1 or B != 2 or T != T_LAT:
        raise AssertionError(f"[timefreq-cli] {len(shapes)} DiT calls of {shapes[0]}; expected "
                             f"{STEPS - 1} at B 2 (CFG) x T {T_LAT}")
    row = stats[0]
    for st in cli.STAGES:
        if st + "_ms" in row:
            print(f"[timefreq-cli] stage {st}: {row[st + '_ms']:.2f} ms host wall, "
                  f"{row[st + '_device_ms']:.2f} ms device")
    step_ms = row["sampler_device_ms"] / (STEPS - 1)
    flops = timefreq_flops(B, T, Ty, TIMEFREQ)
    print(f"[timefreq-cli] sampler: {STEPS - 1} Euler steps at B {B} (CFG) x T {T} (caption "
          f"{Ty} tokens), {step_ms:.2f} ms a step (device; the stage over its steps), "
          f"{flops / 1e12:.2f} TFLOP a step, {flops / step_ms / 1e9:.2f} TFLOP/s; the stage "
          f"{row['sampler_device_ms'] / 1e3:.2f} s")
    wavs = sorted((root / "out_timefreq").rglob("*.wav"))
    if len(wavs) != 1:
        raise AssertionError(f"[timefreq-cli] {len(wavs)} wavs, want 1")
    _check_wav("[timefreq-cli]", wavs[0], (CLI_T_MEL + 7) // 8 * 8 * HOP)
    return dict(k4=k4, step_ms=step_ms, tflops=flops / step_ms / 1e9, params=n_params)


def order_context(dev, bert_dir: Path, seed: int) -> dict:
    """``ORDER_CAPTIONS`` as ConcatOrderDiT's context: WordPiece ids (the
    bert-base-uncased layout: [CLS] 101, '|' 1064, [SEP] 102, [PAD] 0) at
    ``ORDER_TC`` tokens, their BERT hidden states, and per caption one random
    order in [0, 100) per object, 100 past the last."""
    from versband_tpu_torch.text.bert import load_bert
    from versband_tpu_torch.text.tokenizer import WordPieceTokenizer

    tok = WordPieceTokenizer.from_file(str(bert_dir / "tokenizer.json"))
    ids = torch.from_numpy(tok(ORDER_CAPTIONS, max_length=ORDER_TC)["input_ids"]).to(dev)
    bert = load_bert(str(bert_dir)).to(dev).eval()
    with torch.no_grad():
        emb = bert(ids)
    rng = np.random.default_rng(seed)
    orders = np.full((len(ORDER_CAPTIONS), ORDER_MAX_OBJS), 100, np.int64)
    for i, c in enumerate(ORDER_CAPTIONS):
        k = c.count("|") + 1
        orders[i, :k] = rng.integers(0, 100, k)
    return {"token_embedding": emb, "token_ids": ids, "orders": torch.from_numpy(orders).to(dev)}


@torch.no_grad()
def phase_concat_order(dev) -> dict:
    """[concat-order]: ``LatentDiffusionOrder`` over ``ConcatOrderDiT`` at its
    class defaults (built through the resolver), DDIM S 25, eta 0, batch 2,
    no CFG, decode, HiFi-GAN."""
    from versband_tpu_torch.models.concat_dit import ConcatOrderDiT
    from versband_tpu_torch.models.samplers import DDIMSampler
    from versband_tpu_torch.utils.config import instantiate_from_config, load_config
    from versband_tpu_torch.utils.misc import count_params

    if 1 + ORDER_TC + T_LAT > CONCAT_ORDER["max_len"]:
        raise AssertionError(f"[concat-order] 1 + {ORDER_TC} + {T_LAT} tokens exceed max_len")
    t0 = time.perf_counter()
    if not BERT_DIR.exists():
        write_bert_dir(BERT_DIR, BERT_BASE_UNCASED, SEED + 40)
    ctx = order_context(dev, BERT_DIR, SEED + 80)
    params = copy.deepcopy(dict(load_config(str(CLI_CONFIG)).model.params))
    params["first_stage_config"]["params"].pop("ckpt_path", None)
    params.update(unet_config={"target": "ldm.modules.diffusionmodules.concatDiT.ConcatOrderDiT",
                               "params": dict(CONCAT_ORDER)},
                  cond_stage_config=None, conditioning_key="crossattn")
    torch.manual_seed(SEED)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ldm = instantiate_from_config({"target": ORDER_LDM_TARGET, "params": params}, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    if not isinstance(ldm.model, ConcatOrderDiT):
        raise AssertionError(f"[concat-order] built {type(ldm.model).__name__}")
    drawn = perturb_zeros(ldm.model, SEED + 81)
    voc = build_vocoder("hifigan", device=dev)
    n_params = count_params(ldm.model)
    ids = ctx["token_ids"]
    print(f"[concat-order] {type(ldm).__name__} ({ORDER_LDM_TARGET}) over ConcatOrderDiT "
          f"{CONCAT_ORDER}: {n_params / 1e9:.3f} B parameters, {n_params * 4 / 1e9:.2f} GB fp32, "
          f"built on {dev} in {build_s:.2f} s ({drawn / 1e6:.2f} M zero-init weights drawn); "
          f"captions {ORDER_CAPTIONS} -> ids {tuple(ids.shape)} (separators "
          f"{(ids == ORDER_SEP_ID).sum(1).tolist()}, [CLS] {ids[:, 0].tolist()}), orders "
          f"{ctx['orders'].tolist()}, BERT states {tuple(ctx['token_embedding'].shape)}; "
          f"setup {time.perf_counter() - t0:.1f} s")
    events, shape = [], (len(ORDER_CAPTIONS), 20, T_LAT)
    model = _CallThrough(lambda x, t, c: ldm.apply_model(x, t, c), events)
    gen = torch.Generator(device=dev).manual_seed(SEED + 82)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # count only the main path's launches
    t1 = time.perf_counter()
    sampler = DDIMSampler(model, ldm.schedule)
    n_steps = len(sampler.make_schedule(ORDER_DDIM_S)[0])
    z = sampler.sample(shape, ctx, gen, S=ORDER_DDIM_S, eta=0.0, device=dev)
    mel = ldm.decode_first_stage(z)
    wav = voc.waveform(mel)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    k1, k4, k5 = fa.LAUNCHES, fa1.LAUNCHES, fw.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = events[0].elapsed_time(events[-1]) / (len(events) - 1)
    flops = concat_flops(shape[0], T_LAT, ORDER_TC, CONCAT_ORDER)
    n = T_MEL * HOP
    print(f"[concat-order] DDIM S {ORDER_DDIM_S} eta 0 at B {shape[0]}: {len(events)} model "
          f"calls, {step_ms:.2f} ms a step (device, between the calls' ends), "
          f"{flops / 1e12:.2f} TFLOP a step, {flops / step_ms / 1e9:.2f} TFLOP/s; sample + "
          f"decode + HiFi-GAN {wall:.2f} s host wall; peak memory {peak:.2f} GiB; launches K1 "
          f"{k1}, K4 {k4}, K5 {k5}; waveforms {tuple(wav.shape)}, finite "
          f"{bool(torch.isfinite(wav).all())}, std {wav.std().item():.4f}")
    if (len(events) != n_steps or k1 or k4 or k5 or tuple(wav.shape) != (shape[0], n)
            or not torch.isfinite(wav).all() or not wav.std() > 0
            or not torch.isfinite(z).all()):
        raise AssertionError(f"[concat-order] {len(events)} calls, launches {k1}/{k4}/{k5}, "
                             f"waveforms {tuple(wav.shape)}")
    del ldm, voc, ctx, z, mel, wav
    return dict(step_ms=step_ms, tflops=flops / step_ms / 1e9, params=n_params, wall=wall)


@torch.no_grad()
def phase_ae2d(dev) -> None:
    """[ae2d]: AudioLDM's first stage as ``AutoencoderKL2D`` on a
    ``[2, 1, 1024, 64]`` log-mel image: ``encode().mode()`` and ``decode``
    timed on the card, card against CPU."""
    from versband_tpu_torch.models.autoencoder2d import AutoencoderKL2D
    from versband_tpu_torch.utils.misc import count_params

    torch.manual_seed(SEED + 90)
    cpu = AutoencoderKL2D(**AE2D).eval()
    gpu = copy.deepcopy(cpu).to(dev)
    x = torch.randn(AE2D_SHAPE, generator=torch.Generator().manual_seed(SEED + 91)) - 4.0
    xd = x.to(dev)
    z = gpu.encode(xd).mode()
    rec = gpu.decode(z)
    enc_ms = cuda_ms(lambda: gpu.encode(xd).mode(), 5, warmup=1)
    dec_ms = cuda_ms(lambda: gpu.decode(z), 5, warmup=1)
    t0 = time.perf_counter()
    z_cpu = cpu.encode(x).mode()
    rec_cpu = cpu.decode(z_cpu)
    cpu_s = time.perf_counter() - t0
    errs = []
    for name, a, b in (("latent", z, z_cpu), ("reconstruction", rec, rec_cpu)):
        scale = max(1.0, b.abs().max().item())
        errs.append(_max_diff(a, b) / scale)
        print(f"[ae2d] {name} {tuple(b.shape)} card vs CPU: max|d| / max(1, |cpu|max) "
              f"{errs[-1]:.3e} (tol {MODULE_TOL:g}), |cpu|max {b.abs().max().item():.3f}")
    print(f"[ae2d] AutoencoderKL2D {AE2D} ({count_params(cpu) / 1e6:.2f} M parameters) on "
          f"{tuple(x.shape)}: encode().mode() {enc_ms:.2f} ms, decode {dec_ms:.2f} ms (device); "
          f"the CPU took {cpu_s:.1f} s for both")
    if not (max(errs) <= MODULE_TOL and torch.isfinite(rec).all()):
        raise AssertionError(f"[ae2d] the card disagrees with the CPU: {errs}")


def _legacy_cases():
    """(name, module, inputs) at small widths, depth 2, the zero-init weights
    drawn off zero."""
    from versband_tpu_torch.models import concat_dit as cd
    from versband_tpu_torch.models.autoencoder2d import VQModel, VQModelInterface
    from versband_tpu_torch.models.dit_timefreq import TimeFreqMoeDiT
    from versband_tpu_torch.nn.spatial_transformer import SpatialTransformer

    g = torch.Generator().manual_seed(SEED + 100)
    x = torch.randn(2, 20, 96, generator=g)
    t = torch.tensor([124.0, 750.0])
    cap = torch.randn(2, 7, 48, generator=g)
    ids = torch.tensor([[101, 7, 1064, 8, 9, 1064, 11, 102, 0],
                        [101, 5, 6, 1064, 7, 102, 0, 0, 0]])
    order = {"token_embedding": torch.randn(2, 9, 48, generator=g), "token_ids": ids,
             "orders": torch.tensor([[3, 1, 4, 100], [2, 0, 100, 100]])}
    codes = {"c_crossattn": cap, "c_concat": {"acoustic": torch.randint(0, 64, (2, 3, 192),
                                                                        generator=g)}}
    kw = dict(in_channels=20, context_dim=48, hidden_size=128, depth=2, num_heads=4, max_len=256)
    hy = dict(code_num=64, codebook_num=3)
    cases = [("ConcatDiT", cd.ConcatDiT(**kw), (x, t, cap)),
             ("ConcatDiT2MLP", cd.ConcatDiT2MLP(**kw), (x, t, cap)),
             ("HybridDiT2MLP", cd.HybridDiT2MLP(**kw, **hy), (x, t, codes)),
             ("HybridDiT2MLP2 concat_cut", cd.HybridDiT2MLP2(**kw, **hy), (x, t, codes)),
             ("HybridDiT2MLP2 concat_proj", cd.HybridDiT2MLP2(**kw, **hy, cond_fuse="concat_proj"),
              (x, t, codes)),
             ("ConcatOrderDiT", cd.ConcatOrderDiT(**kw), (x, t, order)),
             ("ConcatOrderDiT2", cd.ConcatOrderDiT2(**kw, max_objs=4), (x, t, order)),
             ("TimeFreqMoeDiT", TimeFreqMoeDiT(20, 48, hidden_size=128, depth=2, num_heads=4,
                                               num_experts=8, max_len=256), (x, t, cap))]
    img = torch.randn(2, 64, 16, 12, generator=g)
    ctx = torch.randn(2, 5, 48, generator=g)
    cases += [("SpatialTransformer", SpatialTransformer(64, 4, 16, depth=2), (img,)),
              ("SpatialTransformer context", SpatialTransformer(64, 4, 16, depth=2,
                                                                context_dim=48), (img, ctx))]
    dd = dict(ch=64, ch_mult=[1, 2], num_res_blocks=2, attn_resolutions=[32], in_channels=1,
              resolution=32, z_channels=4, out_ch=1)
    mel = torch.randn(2, 1, 32, 24, generator=g)
    cases += [("VQModel", VQModel(4, 64, ddconfig=dd), (mel,)),
              ("VQModelInterface", VQModelInterface(4, 64, ddconfig=dd), (mel,))]
    for _, m, _ in cases:
        m.eval()
        perturb_zeros(m, SEED + 101, std=0.2)
    return cases


def first(out):
    """A model's output, or the first of a tuple it answers."""
    return out[0] if isinstance(out, tuple) else out


@torch.no_grad()
def phase_legacy_modules(dev) -> None:
    """[legacy-modules]: each new module, card against CPU, fp32, small
    widths, within ``MODULE_TOL`` of scale; VQ indices equal; no K1."""
    torch.manual_seed(SEED + 102)
    reset_launches()
    for name, cpu, args in _legacy_cases():
        gpu = copy.deepcopy(cpu).to(dev)
        if name.startswith("VQModel"):  # the quantizer, then the first-stage interface
            x, xd = args[0], args[0].to(dev)
            (zq, loss, idx), (gzq, gloss, gidx) = cpu.encode_quantized(x), gpu.encode_quantized(xd)
            enc, genc = first(cpu.encode(x)), first(gpu.encode(xd))
            same = torch.equal(gidx.cpu(), idx)
            pairs = [("zq", gzq, zq), ("loss", gloss.reshape(1), loss.reshape(1)),
                     ("encode", genc, enc), ("decode", gpu.decode(genc), cpu.decode(enc))]
        else:
            same, pairs = True, [("out", first(gpu(*[_to(a, dev) for a in args])),
                                  first(cpu(*args)))]
        for what, a, b in pairs:
            scale = max(1.0, b.abs().max().item())
            err = _max_diff(a, b) / scale
            print(f"[legacy-modules] {name} {what} {tuple(b.shape)}: max|d| / max(1, |cpu|max) "
                  f"{err:.3e} (tol {MODULE_TOL:g}), |cpu|max {b.abs().max().item():.3f}"
                  + (f", indices equal {same}" if name.startswith("VQ") else ""))
            if not (err <= MODULE_TOL and torch.isfinite(a).all() and same):
                raise AssertionError(f"[legacy-modules] {name} {what} disagrees: {err}, "
                                     f"indices equal {same}")
    if fa.LAUNCHES:
        raise AssertionError(f"[legacy-modules] {fa.LAUNCHES} K1 launches; the legacy modules "
                             f"attend in plain PyTorch, as in JAX")


def free_card() -> None:
    """Return the cached blocks of the models just dropped."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


class _CallThrough:
    """A backbone that records a CUDA event after each call (to time the
    sampler's steps on the card) and otherwise is the backbone."""

    def __init__(self, model, events: list):
        self.model, self.events = model, events

    def __call__(self, *args, **kw):
        out = self.model(*args, **kw)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        return out


# [tp]: tensor and expert parallelism (the model axis) on one card. Ranks
# share cuda:0 over a gloo group (NCCL takes one card per rank); each runs K1
# forward and K2/K3 backward on its own heads. The times are those of
# processes sharing one card over gloo, not a multi-card figure.
TP_LAYOUTS = ((1, 2), (2, 2))  # (data, model); the first also writes a checkpoint
TP_WORLD, TP_B, TP_T_MEL, TP_STEPS = 4, 8, 1536, 3  # 1536-frame mels -> latent 768
# a constant LR, large enough that 1e-3 x LR is above float32's spacing at the
# LayerNorm weights (1.19e-7 at 1.0: at LR 1e-4 one ulp is 1.19e-3 x LR); Adam's
# eps as the CPU tests' (the key bias's exact zero gradient)
TP_LR, TP_EPS = 1e-3, 1e-3
TP_LOSS_TOL, TP_PARAM_TOL = 1e-4, 1e-3  # relative; x LR x each gathered leaf's scale
TP_WORK = Path("build") / "chip_smoke_tp"


def _tp_inputs() -> tuple:
    """The [tp] phase's CFM (full width, random weights from SEED, on the
    card) and its TP_STEPS + 1 global batches with their draws (posterior, t,
    noise, Gumbel), made alike in every process."""
    torch.manual_seed(SEED)
    unet, vae = training_configs()
    cfm = CFM(unet_config=unet, first_stage_config=vae, mel_dim=DIT["in_channels"],
              scale_by_std=False, scale_factor=0.7, device="cuda", dtype=torch.float32)
    perturb_zero_init(cfm.model, SEED)
    rng = np.random.RandomState(SEED + 40)
    T, z = TP_T_MEL // 2, DIT["in_channels"]
    steps = []
    for _ in range(TP_STEPS + 1):
        batch = {"image": rng.randn(TP_B, 80, TP_T_MEL).astype(np.float32),
                 "caption": rng.randn(TP_B, 80, DIT["ori_dim"]).astype(np.float32),
                 "midi": rng.randint(0, 128, (TP_B, 1, TP_T_MEL)).astype(np.int32),
                 "beats": rng.randint(0, 2, (TP_B, 1, TP_T_MEL)).astype(np.int32)}
        given = {"posterior": rng.randn(TP_B, z, T).astype(np.float32),
                 "t": rng.randint(0, 1000, TP_B).astype(np.int64),
                 "noise": rng.randn(TP_B, z, T).astype(np.float32),
                 "gumbel": [rng.gumbel(size=s).astype(np.float32)
                            for s in cfm.model.gumbel_shapes(TP_B, T)]}
        steps.append((batch, given))
    return cfm, steps


def _tp_on_card(x, dev):
    if isinstance(x, dict):
        return {k: _tp_on_card(v, dev) for k, v in x.items()}
    if isinstance(x, list):
        return [_tp_on_card(v, dev) for v in x]
    return torch.from_numpy(x).to(dev)


def _tp_step(trainer, batch, given, dev, place=lambda b: b):
    given = dict(_tp_on_card(place(given), dev))
    if "gumbel" in given:
        given["gumbel"] = iter(given["gumbel"])
    return trainer.train_step(trainer.state, _tp_on_card(place(batch), dev), given=given)


def _tp_trainer(cfm, logdir, mesh=None):
    trainer = CFMTrainer(cfm, None, learning_rate=TP_LR, logdir=str(logdir), seed=SEED,
                         use_tensorboard=False, log_every_n_steps=10 ** 9, mesh=mesh)
    trainer.tx = make_adamw(TP_LR, eps=TP_EPS, grad_clip=1.0)
    return trainer


def _tp_checksum(module) -> float:
    return float(sum(p.double().sum() for p in module.state_dict().values()))


def _card_rank(rank: int, world: int, rendezvous: str) -> torch.device:
    """Join the gloo group through ``rendezvous`` as ``rank`` of ``world``,
    on cuda:0 (every rank shares the card; NCCL takes one card a rank),
    TF32 off; returns the rank's device."""
    from versband_tpu_torch import parallel

    os.environ.update(RANK=str(rank), LOCAL_RANK="0", WORLD_SIZE=str(world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return parallel.init_from_env("cuda", init_method=f"file://{rendezvous}", backend="gloo")


def _tp_rank(rank: int, world: int, rendezvous: str, out_dir: str) -> None:
    """One rank of [tp]: every layout of TP_LAYOUTS it belongs to, TP_STEPS
    steps each through ``CFMTrainer``'s step on its slice; the first layout
    writes the whole checkpoint (rank 0)."""
    from versband_tpu_torch import parallel
    from versband_tpu_torch.parallel.sharding import gather_state_dict, shard_batch

    dev = _card_rank(rank, world, rendezvous)
    out = {}
    try:
        for layout in TP_LAYOUTS:
            mesh = parallel.make_mesh(*layout)
            if not mesh.member:
                out[layout] = None
                continue
            cfm, steps = _tp_inputs()
            checksum = _tp_checksum(cfm.model) + _tp_checksum(cfm.first_stage)
            trainer = _tp_trainer(cfm, Path(out_dir) / f"run_{layout[0]}x{layout[1]}", mesh)
            trainer.init_state({"image": steps[0][0]["image"]})

            def place(b, mesh=mesh):
                return shard_batch(b, mesh)

            metrics, ms, counts, reduces = [], [], [], []
            for batch, given in steps[:TP_STEPS]:
                torch.cuda.synchronize()
                reset_launches()
                r0 = (parallel.MODEL_REDUCES, parallel.MODEL_REDUCE_BYTES)
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
                m = _tp_step(trainer, batch, given, dev, place)
                ev[1].record()
                torch.cuda.synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
                counts.append(launches())
                reduces.append((parallel.MODEL_REDUCES - r0[0],
                                parallel.MODEL_REDUCE_BYTES - r0[1]))
                metrics.append({k: v.item() for k, v in m.items()})
            params = {k: v.cpu() for k, v in gather_state_dict(cfm.model).items()}
            local = sum(p.numel() * p.element_size() for p in trainer.state.params)
            if layout == TP_LAYOUTS[0]:
                trainer.global_step = TP_STEPS
                trainer.save_checkpoint("last")  # every rank gathers; rank 0 writes
            first = mesh.data_rank == 0 and mesh.model_rank == 0
            out[layout] = {"coords": (mesh.data_rank, mesh.model_rank), "metrics": metrics,
                           "ms": ms, "launches": counts, "reduces": reduces,
                           "state_bytes": 3 * local, "checksum": checksum,
                           "params": params if first else None}
            del trainer, cfm
            free_card()
    finally:
        parallel.leave()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def phase_tp(dev) -> dict:
    """[tp]: the CFM training step under tensor and expert parallelism, at
    full width (hidden 768, 8 heads of 96, depth 4, 4 experts per group,
    caption [8, 80, 1024], batch 8, latent 768; fp32, TF32 off), TP_WORLD
    ranks on cuda:0 over gloo, at each of TP_LAYOUTS, against the same steps
    in this process; the (1, 2) run's whole checkpoint resumed here without
    a group. Returns the ranks' K1/K2/K3 launches (summed)."""
    import torch.multiprocessing as mp

    from versband_tpu_torch import parallel
    from versband_tpu_torch.train.checkpoints import CheckpointManager

    t_phase = time.perf_counter()
    shutil.rmtree(TP_WORK, ignore_errors=True)
    TP_WORK.mkdir(parents=True)
    ranks = mp.start_processes(_tp_rank, args=(TP_WORLD, str((TP_WORK / "rdzv").resolve()),
                                               str(TP_WORK.resolve())),
                               nprocs=TP_WORLD, join=False, start_method="spawn")
    # the same steps in this process, while the ranks run
    cfm, steps = _tp_inputs()
    checksum = _tp_checksum(cfm.model) + _tp_checksum(cfm.first_stage)
    trainer = _tp_trainer(cfm, TP_WORK / "one")
    trainer.init_state({"image": steps[0][0]["image"]})
    one, one_ms = [], []
    for i, (batch, given) in enumerate(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
        ev[0].record()
        m = _tp_step(trainer, batch, given, dev)
        ev[1].record()
        torch.cuda.synchronize()
        one_ms.append(ev[0].elapsed_time(ev[1]))
        one.append({k: v.item() for k, v in m.items()})
        if i == TP_STEPS - 1:
            one_params = {k: v.detach().cpu().clone() for k, v in cfm.model.state_dict().items()}
    whole_bytes = 3 * sum(p.numel() * p.element_size() for p in trainer.state.params)
    del trainer, cfm
    free_card()
    while not ranks.join(timeout=600):
        pass
    got = [torch.load(TP_WORK / f"rank{r}.pt", weights_only=False) for r in range(TP_WORLD)]

    k123 = [0, 0, 0]
    depth = DIT["depth"]
    for layout in TP_LAYOUTS:
        members = [r[layout] for r in got if r[layout] is not None]
        if len(members) != layout[0] * layout[1]:
            raise AssertionError(f"[tp] {layout}: {len(members)} ranks reported")
        for m in members:
            if m["checksum"] != checksum:
                raise AssertionError(f"[tp] {layout} rank {m['coords']}: other initial weights")
            if any(c != (depth, depth, depth) for c in m["launches"]):
                raise AssertionError(f"[tp] {layout} rank {m['coords']}: K1/K2/K3 launches per "
                                     f"step {m['launches']}, expected {depth} each")
            k123 = [a + sum(c[i] for c in m["launches"]) for i, a in enumerate(k123)]
        worst = 0.0
        for i in range(TP_STEPS):
            for k in ("loss", "loss_simple", "lb_loss", "grad_norm"):
                for m in members:
                    gap = abs(m["metrics"][i][k] - one[i][k]) / max(abs(one[i][k]), 1e-30)
                    worst = max(worst, gap)
        if worst > TP_LOSS_TOL:
            raise AssertionError(f"[tp] {layout}: losses or gradient norm {worst:.3e} from the "
                                 f"one-process steps (bar {TP_LOSS_TOL})")
        params = next(m["params"] for m in members if m["params"] is not None)
        if list(params) != list(one_params):
            raise AssertionError(f"[tp] {layout}: gathered names differ from the one-process")
        # each leaf's max|d| in units of LR x the leaf's scale (its largest |value|, at least 1)
        gaps = sorted(((float((params[k] - v).abs().max())
                        / (TP_LR * max(1.0, float(v.abs().max()))), k)
                       for k, v in one_params.items()), reverse=True)
        p_gap = gaps[0][0]
        print(f"[tp] {layout}: the largest parameter gaps (x LR x the leaf's scale): "
              + ", ".join(f"{k} {g:.3e}" for g, k in gaps[:3]))
        if p_gap > TP_PARAM_TOL:
            raise AssertionError(f"[tp] {layout}: gathered parameters {p_gap:.3e} x LR x scale "
                                 f"from the one-process steps (bar {TP_PARAM_TOL})")
        n, b = members[0]["reduces"][-1]
        for m in sorted(members, key=lambda m: m["coords"]):
            print(f"[tp] ({layout[0]} data, {layout[1]} model) rank {m['coords']}: event ms "
                  f"per step {['%.2f' % x for x in m['ms']]}; K1/K2/K3 per step "
                  f"{m['launches'][-1]}; params + Adam state {m['state_bytes'] / 2 ** 20:.1f} "
                  f"MiB (one process: {whole_bytes / 2 ** 20:.1f} MiB)")
        print(f"[tp] ({layout[0]} data, {layout[1]} model): {n} model-axis all-reduces "
              f"a step, {b / 2 ** 20:.1f} MiB a step per rank; losses and gradient norm within "
              f"{worst:.3e} of the one-process steps (bar {TP_LOSS_TOL}), gathered parameters "
              f"within {p_gap:.3e} x LR x scale (bar {TP_PARAM_TOL}); {TP_WORLD} processes "
              f"share one card over gloo: not a multi-card figure")

    # the (1, 2) run's whole checkpoint, resumed without a group
    cfm, steps = _tp_inputs()
    layout = TP_LAYOUTS[0]
    trainer = _tp_trainer(cfm, TP_WORK / "resume")
    trainer.init_state({"image": steps[0][0]["image"]})
    trainer.ckpt = CheckpointManager(str(TP_WORK / f"run_{layout[0]}x{layout[1]}" / "checkpoints"))
    trainer._restore()
    if trainer.global_step != TP_STEPS or trainer.state.step != TP_STEPS:
        raise AssertionError(f"[tp] resumed at step {trainer.global_step}/{trainer.state.step}")
    resumed = _tp_step(trainer, *steps[TP_STEPS], dev)["loss"].item()
    want = one[TP_STEPS]["loss"]
    gap = abs(resumed - want) / abs(want)
    if gap > TP_LOSS_TOL or parallel.active():
        raise AssertionError(f"[tp] the checkpoint of {layout} resumed in one process: step "
                             f"{TP_STEPS + 1} loss {resumed} against {want} uninterrupted")
    print(f"[tp] checkpoint of ({layout[0]} data, {layout[1]} model) resumed in one process: "
          f"step {TP_STEPS + 1} loss {resumed:.6f}, uninterrupted {want:.6f} (|d| {gap:.2e} "
          f"relative); one-process event ms per step {['%.2f' % x for x in one_ms]}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    del trainer, cfm
    free_card()
    shutil.rmtree(TP_WORK, ignore_errors=True)
    return {"launches": tuple(k123)}


# [tp-legacy]: the model axis for the legacy backbones on one card, ranks over
# gloo as in [tp]. The Time/Freq DiT (VideoFlagLargeDiT) at its published
# widths with its depth cut to 4: two ranks of the full depth would need
# 2 x 58.3 GiB of parameters, gradients and Adam state on one card (part (c)
# measures one rank of the full depth alone); a ConcatDiT at hidden 1152,
# 16 heads, depth 2. fp32, TF32 off, Adam eps 1e-3, a constant LR 1e-3 ([tp]'s
# bars), draws fixed where no CLI draws them.
TPL_TIMEFREQ = {**TIMEFREQ, "depth": 4}
TPL_CONCAT = dict(in_channels=20, context_dim=1024, hidden_size=1152, depth=2, num_heads=16,
                  max_len=1000)
TPL_B, TPL_STEPS = 4, 3  # the global batch (1536-frame mels: latent 768)
TPL_WORK = Path("build") / "chip_smoke_tp_legacy"


def _tpl_unet(kind: str) -> dict:
    if kind == "timefreq":
        return {"target": TIMEFREQ_TARGET, "params": dict(TPL_TIMEFREQ)}
    return {"target": "ldm.modules.diffusionmodules.concatDiT.ConcatDiT",
            "params": dict(TPL_CONCAT)}


def _tpl_cfm(kind: str, dev) -> CFM:
    """The CFM over ``kind``'s backbone (random weights from SEED, its
    all-zero layers drawn) and the shipped VAE, fp32 on ``dev``, alike in
    every process."""
    torch.manual_seed(SEED)
    _, vae = training_configs()
    cfm = CFM(unet_config=_tpl_unet(kind), first_stage_config=vae, mel_dim=VAE["embed_dim"],
              scale_by_std=False, scale_factor=0.7, device=dev, dtype=torch.float32)
    perturb_zeros(cfm.model, SEED + 80)
    return cfm


def _tpl_steps(n: int, seed: int) -> list:
    """``n`` global batches (mels, caption embeddings at T5-large's width,
    midi, beats) with their draws (posterior, t, noise)."""
    rng = np.random.RandomState(seed)
    T, z = TP_T_MEL // 2, VAE["embed_dim"]
    steps = []
    for _ in range(n):
        batch = {"image": rng.randn(TPL_B, 80, TP_T_MEL).astype(np.float32),
                 "caption": rng.randn(TPL_B, 80, FLAN_T5_LARGE["d_model"]).astype(np.float32),
                 "midi": rng.randint(0, 128, (TPL_B, 1, TP_T_MEL)).astype(np.int32),
                 "beats": rng.randint(0, 2, (TPL_B, 1, TP_T_MEL)).astype(np.int32)}
        given = {"posterior": rng.randn(TPL_B, z, T).astype(np.float32),
                 "t": rng.randint(0, 1000, TPL_B).astype(np.int64),
                 "noise": rng.randn(TPL_B, z, T).astype(np.float32)}
        steps.append((batch, given))
    return steps


def _tpl_held(model) -> list:
    """Per Time/Freq block: this rank's heads, frequency experts and time
    experts."""
    return [(b.attention.n_local, b.feed_forward.freq_experts.local(),
             b.feed_forward.time_experts.local()) for b in model.layers]


def _param_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params)


@contextlib.contextmanager
def _tpl_patched():
    """For the phase's CLI runs: each dataset item's draws seeded by its
    index (the datasets' own draws are not seeded, ROADMAP Queue 3: as in
    [ddp]), and the trainer's AdamW at eps TP_EPS."""
    from versband_tpu_torch.data.vocal2accomp import JoinManifestSpecs
    from versband_tpu_torch.train import trainer as tmod

    real_item, real_adamw = JoinManifestSpecs.__getitem__, tmod.make_adamw

    def seeded_item(ds, idx):
        ds.rng.reseed([SEED, int(idx)])
        return real_item(ds, idx)

    JoinManifestSpecs.__getitem__ = seeded_item
    tmod.make_adamw = functools.partial(real_adamw, eps=TP_EPS)
    try:
        yield
    finally:
        JoinManifestSpecs.__getitem__, tmod.make_adamw = real_item, real_adamw


def _tpl_cli(argv: list) -> tuple:
    """``cli.train.main(argv)`` from ``CLI_WORK`` under the phase's patches
    and a probe; returns (rc, run, probe, model-axis all-reduces and bytes
    of the run)."""
    from versband_tpu_torch import parallel
    from versband_tpu_torch.cli import train as cli

    run, cwd = {}, os.getcwd()
    r0 = (parallel.MODEL_REDUCES, parallel.MODEL_REDUCE_BYTES)
    try:
        os.chdir(CLI_WORK)
        with _tpl_patched(), _TrainCliProbe() as probe:
            rc = cli.main(argv, run=run)
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    return rc, run, probe, (parallel.MODEL_REDUCES - r0[0], parallel.MODEL_REDUCE_BYTES - r0[1])


def _tpl_cli_rank(rank: int, world: int, rendezvous: str, out_dir: str, argv: list) -> None:
    """A rank of ``cli.train --devices 2 --n_model 2`` as a launcher would
    start it: the environment of its rank, the group joined (gloo, every
    rank on cuda:0), then the CLI, which finds the group."""
    from versband_tpu_torch import parallel

    _card_rank(rank, world, rendezvous)
    try:
        reset_launches()
        rc, run, probe, reduces = _tpl_cli(argv)
        trainer = run["trainer"]
        out = {"rc": rc, "coords": (trainer.mesh.data_rank, trainer.mesh.model_rank),
               "metrics": [{k: v.item() for k, v in m.items()} for m in probe.metrics],
               "ms": [ev[0].elapsed_time(ev[1]) for _, _, ev in probe.steps],
               "launches": launches(), "reduces": reduces, "logdir": run["logdir"],
               "held": _tpl_held(trainer.cfm.model),
               "state_bytes": 3 * _param_bytes(trainer.state.params)}
    finally:
        parallel.leave()
    torch.save(out, os.path.join(out_dir, f"cli_rank{rank}.pt"))


def _tpl_rank(rank: int, world: int, rendezvous: str, out_dir: str) -> None:
    """A rank of ``CFMTrainer(mesh=)``: the Time/Freq DiT at (2 data, 2
    model), then the ConcatDiT at (1, 2), TPL_STEPS steps each on fixed
    draws; the first rank of each writes the gathered weights."""
    from versband_tpu_torch import parallel
    from versband_tpu_torch.parallel.sharding import gather_state_dict, shard_batch

    dev = _card_rank(rank, world, rendezvous)
    out = {}
    try:
        for kind, layout, seed in (("timefreq", (2, 2), SEED + 82), ("concat", (1, 2), SEED + 83)):
            mesh = parallel.make_mesh(*layout)
            out[kind] = None
            if not mesh.member:
                continue
            cfm, steps = _tpl_cfm(kind, "cuda"), _tpl_steps(TPL_STEPS, seed)
            trainer = _tp_trainer(cfm, Path(out_dir) / f"run_{kind}", mesh)
            trainer.init_state({"image": steps[0][0]["image"]})
            cut = trainer.state.layout
            row = {"coords": (mesh.data_rank, mesh.model_rank), "metrics": [], "ms": [],
                   "launches": [], "reduces": [],
                   "state_bytes": 3 * _param_bytes(trainer.state.params),
                   "slices": len(cut.slices), "owned": len(cut.owned), "absent": len(cut.absent),
                   "held": _tpl_held(cfm.model) if kind == "timefreq" else None}
            for batch, given in steps:
                torch.cuda.synchronize()
                reset_launches()
                r0 = (parallel.MODEL_REDUCES, parallel.MODEL_REDUCE_BYTES)
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
                m = _tp_step(trainer, batch, given, dev, lambda b, mesh=mesh: shard_batch(b, mesh))
                ev[1].record()
                torch.cuda.synchronize()
                row["ms"].append(ev[0].elapsed_time(ev[1]))
                row["launches"].append(launches())
                row["reduces"].append((parallel.MODEL_REDUCES - r0[0],
                                       parallel.MODEL_REDUCE_BYTES - r0[1]))
                row["metrics"].append({k: v.item() for k, v in m.items()})
            params = gather_state_dict(cfm.model)
            if mesh.data_rank == 0 and mesh.model_rank == 0:
                torch.save({k: v.cpu() for k, v in params.items()},
                           os.path.join(out_dir, f"{kind}_params.pt"))
            out[kind] = row
            del trainer, cfm, params
            free_card()
    finally:
        parallel.leave()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _tpl_one(kind: str, dev, seed: int) -> dict:
    """The same steps as ``_tpl_rank``'s in this process, without a group."""
    cfm, steps = _tpl_cfm(kind, dev), _tpl_steps(TPL_STEPS, seed)
    trainer = _tp_trainer(cfm, TPL_WORK / f"one_{kind}")
    trainer.init_state({"image": steps[0][0]["image"]})
    metrics, ms = [], []
    for batch, given in steps:
        ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
        ev[0].record()
        m = _tp_step(trainer, batch, given, dev)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        metrics.append({k: v.item() for k, v in m.items()})
    out = {"metrics": metrics, "ms": ms, "state_bytes": 3 * _param_bytes(trainer.state.params),
           "params": {k: v.detach().cpu().clone() for k, v in cfm.model.state_dict().items()}}
    del trainer, cfm
    free_card()
    return out


def _tpl_agree(tag: str, runs: list, want: list, params, want_params) -> tuple:
    """Each rank's steps (``runs``: a list of metrics per step for each
    rank) against the one-process run's losses and gradient norm (relative,
    TP_LOSS_TOL), and each leaf of ``params`` against ``want_params`` in
    units of LR x the leaf's scale (TP_PARAM_TOL); returns the two worst
    gaps."""
    worst = 0.0
    for run in runs:
        for g, w in zip(run, want, strict=True):
            for k in ("loss", "loss_simple", "lb_loss", "grad_norm"):
                worst = max(worst, abs(g[k] - w[k]) / max(abs(w[k]), 1e-30))
    if worst > TP_LOSS_TOL:
        raise AssertionError(f"[tp-legacy] {tag}: losses or gradient norm {worst:.3e} from the "
                             f"one-process steps (bar {TP_LOSS_TOL})")
    if set(params) != set(want_params):
        raise AssertionError(f"[tp-legacy] {tag}: gathered names differ from the one-process")
    gaps = []
    for k, v in want_params.items():
        v = v.float()
        d = float((params[k].to(v.device).float() - v).abs().max())
        gaps.append((d / (TP_LR * max(1.0, float(v.abs().max()))), k))
    gaps.sort(reverse=True)
    print(f"[tp-legacy] {tag}: the largest parameter gaps (x LR x the leaf's scale): "
          + ", ".join(f"{k} {g:.3e}" for g, k in gaps[:3]))
    if gaps[0][0] > TP_PARAM_TOL:
        raise AssertionError(f"[tp-legacy] {tag}: gathered parameters {gaps[0][0]:.3e} x LR x "
                             f"scale from the one-process steps (bar {TP_PARAM_TOL})")
    return worst, gaps[0][0]


def _tpl_check_held(tag: str, coords, held: list) -> None:
    """8 of 16 heads and 4 of 8 frequency experts per block (this rank's),
    all 8 time experts."""
    E, H, r = TIMEFREQ["num_experts"], TIMEFREQ["num_heads"], coords[1]
    want = (H // 2, list(range(r * E // 2, (r + 1) * E // 2)), list(range(E)))
    if len(held) != TPL_TIMEFREQ["depth"] or any(tuple(b) != want for b in held):
        raise AssertionError(f"[tp-legacy] {tag} rank {coords}: holds {held}, want {want} "
                             f"per block")


def _card_bytes() -> tuple:
    """The caching allocator's (requested, allocated) bytes: what tensors
    asked for, and the blocks that hold them (a block is not split for a
    remainder under 1 MiB, so it can be larger)."""
    st = torch.cuda.memory_stats()
    return st["requested_bytes.all.current"], st["allocated_bytes.all.current"]


def _tpl_rank_bytes(dev, m: int) -> tuple:
    """Rank 0's part of the Time/Freq DiT at depth 28 cut at (1, m) by a mesh
    without a group (cutting needs no collective), with its gradients and
    Adam state made; returns (its parameters, the bytes its tensors
    requested, the allocator's bytes, seconds). Its tensors are freed when
    this returns."""
    from versband_tpu_torch.models.dit_timefreq import TimeFreqMoeDiT
    from versband_tpu_torch.parallel.mesh import Mesh
    from versband_tpu_torch.parallel.sharding import shard_module_

    base, t0 = _card_bytes(), time.perf_counter()
    with torch.device(dev):
        model = TimeFreqMoeDiT(**TIMEFREQ)
    shard_module_(model, Mesh(1, m, 0, 0))
    state = TrainState(model, make_adamw(TP_LR, eps=TP_EPS, grad_clip=1.0))
    for p in state.params:
        p.grad = torch.zeros_like(p)
    for group in state.optimizer.param_groups:
        group["foreach"] = False  # no temporaries the size of every parameter
    state.optimizer.step()  # Adam's moments, made as its first step makes them
    torch.cuda.synchronize()
    req, got = (b - a for a, b in zip(base, _card_bytes()))
    return sum(p.numel() for p in state.params), req, got, time.perf_counter() - t0


def _tpl_full_depth(dev, smi: str) -> dict:
    """(c): one rank's part of the Time/Freq DiT at depth 28, at (1, 2) and
    (1, 4): the bytes its parameters, gradients and Adam state take on the
    card against the arithmetic (4 x 4 bytes a parameter), the allocator's
    blocks against the card's memory, and the one process's arithmetic."""
    from versband_tpu_torch.models.dit_timefreq import TimeFreqMoeDiT

    with torch.device("meta"):
        whole = sum(p.numel() for p in TimeFreqMoeDiT(**TIMEFREQ).parameters())
    total = torch.cuda.get_device_properties(0).total_memory
    out = {"whole_params": whole}
    for m in (2, 4):
        free_card()
        n, req, got, secs = _tpl_rank_bytes(dev, m)
        want = 16 * n  # fp32 parameter, gradient, Adam's two moments
        print(f"[tp-legacy] (c) {TIMEFREQ_TARGET} depth {TIMEFREQ['depth']}, rank 0 of (1 data, "
              f"{m} model): {n:,} parameters; parameters + gradients + Adam state "
              f"{req / 2 ** 30:.2f} GiB requested on the card (arithmetic "
              f"{want / 2 ** 30:.2f} GiB), {got / 2 ** 30:.2f} GiB in the allocator's blocks, "
              f"of the card's {total / 2 ** 30:.2f} GiB (total_memory); one process "
              f"{16 * whole / 2 ** 30:.2f} GiB, {whole:,} parameters, by arithmetic only; "
              f"built, cut and stepped in {secs:.1f} s; {smi}")
        # the cut's index tensors aside (under 1 MiB), the tensors are the arithmetic
        if not 0 <= req - want < 2 ** 20 or got >= total:
            raise AssertionError(f"[tp-legacy] (c) model {m}: {req} bytes requested against "
                                 f"{want} by arithmetic, {got} allocated of {total}")
        out[m] = {"params": n, "requested": req, "allocated": got}
    free_card()
    return out


def phase_tp_legacy(dev, smi: str) -> dict:
    """[tp-legacy]: the model axis for the legacy backbones, ranks sharing
    cuda:0 over gloo. (a) The Time/Freq DiT (``TPL_TIMEFREQ``): ``cli.train
    --devices 2 --n_model 2`` on configs/vocal2music.yaml with its
    ``unet_config`` swapped, 3 steps, against the same CLI run in this
    process, its whole checkpoint resumed here for a 4th step; then
    ``CFMTrainer(mesh=)`` at (2, 2) on fixed draws against the same steps
    here. (b) A ConcatDiT (``TPL_CONCAT``) at (1, 2): nothing cut, each
    rank holding the whole model. (c) One rank's bytes at the full depth.
    Returns the phase's K1/K2/K3 launches (none: the attention is plain, as
    in JAX)."""
    import torch.multiprocessing as mp

    from versband_tpu_torch import parallel
    from versband_tpu_torch.cli import train as cli
    from versband_tpu_torch.train.checkpoints import CheckpointManager
    from versband_tpu_torch.utils.config import config_to_yaml, load_config

    t_phase = time.perf_counter()
    shutil.rmtree(TPL_WORK, ignore_errors=True)
    TPL_WORK.mkdir(parents=True)
    work, out_dir = CLI_WORK.resolve(), TPL_WORK.resolve()
    # (a) the shipped YAML, the backbone swapped; batch 4, a constant LR 1e-3,
    # no validation set and no loggers (the phase times the steps)
    cfg = load_config(str(CLI_CONFIG))
    params = cfg["model"]["params"]
    params["unet_config"] = _tpl_unet("timefreq")
    params.pop("scheduler_config")
    cfg["model"]["base_learning_rate"] = TP_LR
    cfg["data"]["params"]["batch_size"] = TPL_B
    cfg["data"]["params"].pop("validation")
    cfg.pop("lightning")
    (work / "tp_legacy.yaml").write_text(config_to_yaml(cfg))
    data = work / "train_data"
    argv = ["-b", str(work / "tp_legacy.yaml"), "-t", "-l", str(out_dir / "logs"),
            "-s", str(SEED), "--no-test", "--scale_lr", "false",
            "--max_steps", str(TPL_STEPS), "--max_epochs", "1",
            f"data.params.main_spec_dir_path={data / 'manifests'}",
            f"data.params.other_condition={data / 'midi.npy'}",
            f"model.params.first_stage_config.params.ckpt_path={work / 'vae.pt'}"]
    t0 = time.perf_counter()
    mp.start_processes(_tpl_cli_rank, args=(2, str(out_dir / "rdzv_cli"), str(out_dir),
                                            argv + ["--devices", "2", "--n_model", "2",
                                                    "-n", "model2"]),
                       nprocs=2, join=True, start_method="spawn")
    cli_s = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"cli_rank{r}.pt", weights_only=False) for r in range(2)]
    reset_launches()
    t0 = time.perf_counter()
    rc, run, probe, _ = _tpl_cli(argv + ["-n", "one"])
    one_s = time.perf_counter() - t0
    if parallel.active() or rc != 0 or any(r["rc"] != 0 for r in ranks):
        raise AssertionError(f"[tp-legacy] cli.train returned {rc}, ranks "
                             f"{[r['rc'] for r in ranks]}")
    one = [{k: v.item() for k, v in m.items()} for m in probe.metrics]
    trainer = run["trainer"]
    k123 = [launches()] + [r["launches"] for r in ranks]
    for r in ranks:
        _tpl_check_held("cli (1, 2)", r["coords"], r["held"])
    ckpt_dir = Path(ranks[0]["logdir"]) / "checkpoints"
    saved = torch.load(ckpt_dir / "last.pt", map_location="cpu", mmap=True, weights_only=False)
    worst, p_gap = _tpl_agree("cli (1, 2)", [r["metrics"] for r in ranks], one,
                              saved["model"], trainer.cfm.model.state_dict())
    n_red, b_red = ranks[0]["reduces"]
    one_bytes = 3 * _param_bytes(trainer.state.params)
    for r in sorted(ranks, key=lambda r: r["coords"]):
        print(f"[tp-legacy] cli.train --devices 2 --n_model 2, rank {r['coords']}: event ms "
              f"per step {['%.2f' % x for x in r['ms']]}; per block {r['held'][0][0]} of "
              f"{TIMEFREQ['num_heads']} heads, frequency experts {r['held'][0][1]}, all "
              f"{len(r['held'][0][2])} time experts; params + Adam state "
              f"{r['state_bytes'] / 2 ** 30:.2f} GiB (one process "
              f"{one_bytes / 2 ** 30:.2f} GiB); {n_red / TPL_STEPS:.0f} model-axis "
              f"all-reduces, {b_red / TPL_STEPS / 2 ** 20:.1f} MiB a step; K1/K2/K3 "
              f"{r['launches']}; {smi}")
    print(f"[tp-legacy] cli (1 data, 2 model) against the same CLI run in one process: "
          f"losses and gradient norm within {worst:.3e} (bar "
          f"{TP_LOSS_TOL}), the checkpoint's weights within {p_gap:.3e} x LR "
          f"x scale (bar {TP_PARAM_TOL}); one-process event ms per step "
          f"{['%.2f' % (ev[0].elapsed_time(ev[1])) for _, _, ev in probe.steps]}; the 2 ranks "
          f"took {cli_s:.1f} s, the one-process run {one_s:.1f} s (process starts, the T5 "
          f"tower's load, the whole checkpoint's write included)")

    # the (1, 2) checkpoint resumed in this process, a 4th step on fixed draws
    # against the one-process run's 4th step on the same draws
    (batch, given), = _tpl_steps(1, SEED + 81)
    want = _tp_step(trainer, batch, given, dev)["loss"].item()
    del run, trainer, probe, saved
    free_card()
    cfm = _tpl_cfm("timefreq", dev)
    cli.load_first_stage(cfm, str(work / "vae.pt"))
    resumed = _tp_trainer(cfm, out_dir / "resume")
    resumed.init_state({"image": batch["image"]})
    resumed.ckpt = CheckpointManager(str(ckpt_dir))
    resumed._restore()
    got = _tp_step(resumed, batch, given, dev)["loss"].item()
    gap = abs(got - want) / abs(want)
    print(f"[tp-legacy] the cli (1, 2) checkpoint resumed in one process at step "
          f"{resumed.global_step}: step {TPL_STEPS + 1} loss {got:.6f}, the one-process run's "
          f"{want:.6f} (|d| {gap:.2e} relative, bar {TP_LOSS_TOL})")
    if resumed.global_step != TPL_STEPS or gap > TP_LOSS_TOL or launches() != (0, 0, 0):
        raise AssertionError(f"[tp-legacy] resume: step {resumed.global_step}, loss {got} "
                             f"against {want}, launches {launches()}")
    del resumed, cfm
    free_card()
    shutil.rmtree(out_dir / "logs", ignore_errors=True)

    # (a) at (2, 2) and (b) through CFMTrainer(mesh=), four ranks; the
    # one-process steps here (the Time/Freq ones first: the card holds one
    # side at a time; the ConcatDiT ones while the ranks run)
    ref = {"timefreq": _tpl_one("timefreq", dev, SEED + 82)}
    t0 = time.perf_counter()
    procs = mp.start_processes(_tpl_rank, args=(4, str(out_dir / "rdzv"), str(out_dir)),
                               nprocs=4, join=False, start_method="spawn")
    ref["concat"] = _tpl_one("concat", dev, SEED + 83)
    while not procs.join(timeout=600):
        pass
    ranks_s = time.perf_counter() - t0
    got = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(4)]
    for kind, layout in (("timefreq", (2, 2)), ("concat", (1, 2))):
        members = [r[kind] for r in got if r[kind] is not None]
        if len(members) != layout[0] * layout[1]:
            raise AssertionError(f"[tp-legacy] {kind} {layout}: {len(members)} ranks reported")
        gathered = torch.load(out_dir / f"{kind}_params.pt", mmap=True, weights_only=False)
        worst, p_gap = _tpl_agree(f"{kind} {layout}", [m["metrics"] for m in members],
                                  ref[kind]["metrics"], gathered, ref[kind]["params"])
        for m in members:
            k123 += m["launches"]
            if kind == "timefreq":
                _tpl_check_held(f"{kind} {layout}", m["coords"], m["held"])
            elif (m["slices"], m["owned"], m["absent"]) != (0, 0, 0) \
                    or m["state_bytes"] != ref[kind]["state_bytes"]:
                raise AssertionError(f"[tp-legacy] {kind} rank {m['coords']}: cut "
                                     f"{m['slices']}/{m['owned']}/{m['absent']}, "
                                     f"{m['state_bytes']} bytes against "
                                     f"{ref[kind]['state_bytes']} in one process")
        n, b = members[0]["reduces"][-1]
        for m in sorted(members, key=lambda m: m["coords"]):
            print(f"[tp-legacy] {kind} ({layout[0]} data, {layout[1]} model) rank "
                  f"{m['coords']}: event ms per step {['%.2f' % x for x in m['ms']]}; params + "
                  f"Adam state {m['state_bytes'] / 2 ** 30:.3f} GiB (one process "
                  f"{ref[kind]['state_bytes'] / 2 ** 30:.3f} GiB); cut leaves "
                  f"{m['slices']}, experts owned {m['owned'] // 3} and absent "
                  f"{m['absent'] // 3}; K1/K2/K3 per step {m['launches'][-1]}")
        print(f"[tp-legacy] {kind} ({layout[0]} data, {layout[1]} model): {n} model-axis "
              f"all-reduces, {b / 2 ** 20:.1f} MiB a step per rank; losses and gradient norm "
              f"within {worst:.3e}, gathered parameters within "
              f"{p_gap:.3e} x LR x scale of the one-process steps (event ms "
              f"{['%.2f' % x for x in ref[kind]['ms']]}); {smi}")
    if any(tuple(c) != (0, 0, 0) for c in k123):
        raise AssertionError(f"[tp-legacy] K1/K2/K3 launched on a plain-attention path: {k123}")
    del ref, got
    free_card()

    full = _tpl_full_depth(dev, smi)
    shutil.rmtree(TPL_WORK, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print(f"[tp-legacy] phase {wall:.1f} s (the CLI ranks {cli_s:.1f} s, the trainer ranks "
          f"{ranks_s:.1f} s); processes that share one card over gloo, not a multi-card "
          f"figure; {smi}")
    return {"launches": (0, 0, 0), "wall_s": wall, "full": full}

def main() -> None:
    t_start = time.perf_counter()
    smi = phase_card()
    dev = torch.device("cuda")
    parents = phase_build()
    k1 = phase_k1(dev)
    k23 = phase_k23(dev)
    k4 = phase_k4(dev, parents.get("fused_act1d"))
    k5 = phase_k5(dev, parents.get("fused_wavenet"))
    phase_modules(dev)
    served = phase_serve(dev)
    bf16 = phase_bf16_serve(dev)
    trained = phase_train(dev)
    phase_grad_parity(dev)
    n_cli = phase_cli(dev)
    n_train_cli = phase_train_cli(dev)
    n_vae_cli, n_vae_gen = phase_vae_train_cli(dev)
    t_phase = time.perf_counter()
    prep = phase_prep_cli(dev)
    prep["wall_s"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    ddp = phase_ddp(dev)
    ddp["wall_s"] = time.perf_counter() - t_phase
    tp = phase_tp(dev)
    tp_legacy = phase_tp_legacy(dev, smi)
    t_phase = time.perf_counter()
    timefreq = phase_timefreq_cli(dev)
    timefreq["wall_s"] = time.perf_counter() - t_phase
    shutil.rmtree(CLI_WORK, ignore_errors=True)
    free_card()
    phase_vae_step_parity(dev)
    voc_hifigan = phase_voc_train_hifigan(dev)
    voc_bigvgan = phase_voc_train_bigvgan(dev)
    voc_pwg = phase_voc_train_pwg(dev)
    phase_voc_step_parity(dev)
    t_phase = time.perf_counter()
    phase_legacy_modules(dev)
    phase_ae2d(dev)
    legacy_s = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    order = phase_concat_order(dev)
    order["wall_s"] = time.perf_counter() - t_phase
    free_card()
    audioldm = phase_audioldm(dev)
    print(f"[legacy] TimeFreqMoeDiT {timefreq['params'] / 1e9:.3f} B: {timefreq['step_ms']:.2f} "
          f"ms an Euler step, {timefreq['tflops']:.2f} TFLOP/s ([timefreq-cli] phase "
          f"{timefreq['wall_s']:.1f} s); ConcatOrderDiT {order['params'] / 1e9:.3f} B: "
          f"{order['step_ms']:.2f} ms a DDIM step, {order['tflops']:.2f} TFLOP/s ([concat-order] "
          f"phase {order['wall_s']:.1f} s); [legacy-modules] and [ae2d] {legacy_s:.1f} s")
    print(f"[voc-train] per step (device, median): hifigan {voc_hifigan['ms']:.2f} ms "
          f"({voc_hifigan['peak_gib']:.2f} GiB), bigvgan {voc_bigvgan['ms']:.2f} ms "
          f"({voc_bigvgan['peak_gib']:.2f} GiB), pwg {voc_pwg['ms']:.2f} ms "
          f"({voc_pwg['peak_gib']:.2f} GiB); on the trained generators K4 "
          f"{voc_bigvgan['k4_ms']:.3f} ms and K5 {voc_pwg['k5_ms']:.3f} ms per launch")
    n_train = tuple(sum(n) for n in zip(trained["launches"], n_train_cli, prep["launches"],
                                        ddp["launches"], tp["launches"]))
    n_serve = {k: sum(f[k] for f in served.values()) for k in ("k1", "k4", "k5")}
    bwd_src = "versband_tpu_torch/ops/csrc/flash_attn_bwd.cu"
    table = [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "versband_tpu_torch/ops/csrc/flash_attn_fwd.cu",
         "replaces": "versband_tpu/ops/flash_attention.py:57",
         "launches": n_serve["k1"] + bf16["k1"] + n_train[0] + n_cli + n_vae_gen
         + audioldm["k1"], **k1},
        {"name": "flash_attn_bwd_dq", "route": "cuda", "source": bwd_src,
         "replaces": "versband_tpu/ops/flash_attention.py:162", "launches": n_train[1],
         **k23["dq"]},
        {"name": "flash_attn_bwd_dkv", "route": "cuda", "source": bwd_src,
         "replaces": "versband_tpu/ops/flash_attention.py:196", "launches": n_train[2],
         **k23["dkv"]},
        {"name": "fused_alias_free_snake", "route": "cuda",
         "source": "versband_tpu_torch/ops/csrc/fused_act1d.cu",
         "replaces": "versband_tpu/ops/fused_act1d.py:94",
         "launches": n_serve["k4"] + n_vae_cli + voc_bigvgan["k4"] + timefreq["k4"], **k4},
        {"name": "fused_wavenet_layer", "route": "cuda",
         "source": "versband_tpu_torch/ops/csrc/fused_wavenet.cu",
         "replaces": "versband_tpu/ops/fused_wavenet.py:46",
         "launches": n_serve["k5"] + voc_pwg["k5"], **k5},
    ]
    if not all(k["launches"] > 0 for k in table):
        raise AssertionError(f"a kernel did not run on the main path: "
                             f"{[(k['name'], k['launches']) for k in table]}")
    print(f"[prep-cli] mel per {PREP_SEC:.0f} s clip {prep['mel_ms']:.3f} ms, max|d| card vs "
          f"CPU {prep['mel_err']:.3e}; rows kept {prep['kept']}, dropped {prep['dropped']}; "
          f"K1/K2/K3 {prep['launches']}. [ddp] NCCL world size 1: losses within "
          f"{ddp['loss_diff']:.3e} of the run without a group, all-reduce of "
          f"{ddp['allreduce_bytes']} bytes {ddp['allreduce_ms']:.3f} ms a step, K1/K2/K3 "
          f"{ddp['launches']} (both in-process runs); the phases took {prep['wall_s']:.1f} s "
          f"and {ddp['wall_s']:.1f} s")
    print(f"kernels: {[k['name'] for k in table]}; K1 launches: serving {n_serve['k1']}, "
          f"bf16-serve {bf16['k1']}, "
          f"training {trained['launches'][0]}, cli {n_cli}, train-cli {n_train_cli[0]}, "
          f"prep-cli {prep['launches'][0]}, ddp {ddp['launches'][0]}, tp {tp['launches'][0]} "
          f"(its ranks' K2/K3 {tp['launches'][1]}/{tp['launches'][2]}; tp-legacy "
          f"{tp_legacy['launches']}), "
          f"vae-train-cli's cli.generate {n_vae_gen} "
          f"(train-cli's K2/K3 {n_train_cli[1]}/{n_train_cli[2]}), audioldm {audioldm['k1']}; "
          f"K4 {n_serve['k4']} (bigvgan) + "
          f"{n_vae_cli} (vae-train-cli audio logs) + {voc_bigvgan['k4']} (the trained "
          f"BigVGAN) + {timefreq['k4']} (timefreq-cli), K5 {n_serve['k5']} (pwg) + {voc_pwg['k5']} (the trained PWG)")
    print(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s wall, kernel builds included")
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
