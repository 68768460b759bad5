#!/usr/bin/env python3
"""Where a training step's time goes on one NVIDIA GPU.

Builds the shipped-width fp32 training model of ``chip_smoke.py`` (random
weights from its seed, batch 8, 1536 mel frames -> latent 768), takes two
warm-up steps of ``make_cfm_train_step`` (frozen-VAE encode, loss, backward,
clip, AdamW), then one step timed on the host clock up to a synchronize and
one under ``torch.profiler``. Prints wall ms, device-busy ms (union of kernel
intervals), the idle share of the card, the kernel count, the time in the
flash-attention kernels (K1 forward, K2 dQ, K3 dK/dV), and the kernels that
take the most device time.

Run from the repository root:  python3 profile_training.py
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from profile_serving import busy_ms
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.train.lr_schedules import scale_base_lr
from versband_tpu_torch.train.state import TrainState, make_adamw
from versband_tpu_torch.train.step import make_cfm_train_step

TOP = 16
FLASH = (("K1", "flash_fwd"), ("K2", "flash_bwd_dq"), ("K3", "flash_bwd_dkv"))


def main() -> None:
    cs.phase_card()
    dev = torch.device("cuda")
    torch.manual_seed(cs.SEED)
    unet, vae = cs.training_configs()
    cfm = CFM(unet_config=unet, first_stage_config=vae, mel_dim=cs.DIT["in_channels"],
              scale_by_std=False, scale_factor=0.9, device=dev, dtype=torch.float32)
    cs.perturb_zero_init(cfm.model, cs.SEED)
    state = TrainState(cfm.model, make_adamw(scale_base_lr(cs.BASE_LR, cs.TRAIN_B, 1, 1),
                                             grad_clip=1.0))
    step_fn = make_cfm_train_step(cfm)
    rng = np.random.RandomState(cs.SEED + 20)
    B, t_mel = cs.TRAIN_B, 2 * cs.T_TRAIN
    batch = {"image": rng.randn(B, 80, t_mel).astype(np.float32),
             "caption": rng.randn(B, 80, cs.DIT["ori_dim"]).astype(np.float32),
             "midi": rng.randint(0, 128, (B, 1, t_mel)), "beats": rng.randint(0, 2, (B, 1, t_mel))}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def step():
        return step_fn(state, batch, gen)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device kernels")
    busy = busy_ms(kernels)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for k in kernels:
        by_name[k.name][0] += 1
        by_name[k.name][1] += (k.time_range.end - k.time_range.start) / 1e3
    flash = {tag: [sum(c for n, (c, _) in by_name.items() if key in n),
                   sum(t for n, (_, t) in by_name.items() if key in n)] for tag, key in FLASH}
    print(f"[train step] fp32, batch {B}, latent {cs.T_TRAIN}: wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms, idle {1 - busy / wall:.1%}, {len(kernels)} kernels; "
          + ", ".join(f"{tag} {t:.3f} ms in {c} launches" for tag, (c, t) in flash.items())
          + f" ({sum(t for _, t in flash.values()) / busy:.1%} of busy)")
    for n, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]:
        print(f"[train step]   {t:8.3f} ms {c:6d}x  {n[:110]}")


if __name__ == "__main__":
    main()
