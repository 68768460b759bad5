"""Training CLI (port of ``versband_tpu/cli/train.py``).

    python -m versband_tpu_torch.cli.train --base configs/vocal2music.yaml -t \\
        --max_steps 100000 --steps_per_call 2 name.of.key=value ...

Runs on the card unless ``--platform cpu`` is given:

* ``--base`` configs are merged in order, then the ``key=value`` overrides;
* ``-r <logdir>`` resumes: the configs archived under ``<logdir>/configs`` are
  read first, and the last checkpoint (its step and ``scale_factor``) is
  restored;
* the learning rate is ``accumulate x devices x batch size x
  base_learning_rate`` unless ``--scale_lr false``;
* the run's directory is ``<logdir>/<now>_<name>/{checkpoints,configs,tb,
  images,audio}``;
* the first stage is loaded from ``first_stage_config.params.ckpt_path``
  where it exists, else it keeps a random init, which is printed;
* after ``fit``, ``test`` runs unless ``--no-test``.

One card only: ``--devices`` or ``--n_model`` above 1 raise (ROADMAP Queue
1 item 12), and so does a stage-1 model (``AutoencoderKL``, item 10).
"""

from __future__ import annotations

import argparse
import datetime
import glob
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from versband_tpu_torch.utils.config import (
    Config, apply_dot_overrides, instantiate_from_config, load_config, merge_configs)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("versband_tpu_torch trainer")
    p.add_argument("-n", "--name", type=str, default="")
    p.add_argument("-r", "--resume", type=str, default="")
    p.add_argument("-b", "--base", nargs="*", metavar="base_config.yaml", default=[])
    p.add_argument("-t", "--train", action="store_true", default=False)
    p.add_argument("--no-test", action="store_true", default=False)
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("-l", "--logdir", type=str, default="logs")
    p.add_argument("--devices", type=int, default=None,
                   help="number of cards (one card only; more is ROADMAP item 12)")
    p.add_argument("--n_model", type=int, default=1,
                   help="model-parallel axis size (1 only; more is ROADMAP item 12)")
    p.add_argument("--scale_lr", type=str, default="true")
    p.add_argument("--max_steps", type=int, default=10 ** 9)
    p.add_argument("--max_epochs", type=int, default=1000)
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="train steps per call over stacked batches (one metrics readback "
                        "per call)")
    p.add_argument("--prefetch_groups", type=int, default=1,
                   help="steps or groups assembled ahead on a worker thread (caption "
                        "tower, stacking, copies to the card); 0 = inline")
    p.add_argument("--transfer_dtype", type=str, default=None, choices=(None, "float16"),
                   help="send mels to the card as fp16 (ids always go as int16), widened "
                        "there; rounds the input mels to fp16")
    p.add_argument("--caption_cache_dir", type=str, default=None,
                   help="opt-in cache of caption embeddings ('auto' = <logdir>/caption_cache); "
                        "pays only for a small, fixed caption set")
    p.add_argument("--platform", type=str, default=None,
                   help="'cpu' to run on the CPU; default: the card (cuda)")
    return p


def build_logdir(opt, now: str) -> str:
    if opt.resume:
        return opt.resume.rstrip("/")
    cfg_name = opt.name or (os.path.splitext(os.path.basename(opt.base[0]))[0]
                            if opt.base else "run")
    return os.path.join(opt.logdir, f"{now}_{cfg_name}")


def scaled_lr(opt, ndev: int, bs: int, base_lr: float) -> float:
    """The run's LR, and the line that states it."""
    if opt.scale_lr.lower() in ("true", "1", "yes"):
        lr = opt.accumulate_grad_batches * ndev * bs * base_lr
        print(f"Setting learning rate to {lr:.2e} = {opt.accumulate_grad_batches}"
              f" (accumulate) * {ndev} (devices) * {bs} (bs) * {base_lr:.2e} (base)")
        return lr
    print(f"Using base learning rate {base_lr:.2e}")
    return base_lr


def main(argv: Optional[List[str]] = None, run: Optional[Dict[str, Any]] = None) -> int:
    """Run the CLI on ``argv``. ``run``, when given, receives the run's
    ``trainer``, ``config`` and ``logdir``."""
    opt, unknown = get_parser().parse_known_args(argv)
    if (opt.devices or 1) > 1 or opt.n_model > 1:
        raise NotImplementedError("training on more than one card is not ported yet "
                                  "(ROADMAP Queue 1 item 12)")
    from versband_tpu_torch.device import resolve_device

    device = resolve_device(opt.platform)
    now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")

    bases = list(opt.base)
    if opt.resume:
        bases = sorted(glob.glob(os.path.join(opt.resume, "configs/*.yaml"))) + bases
    if not bases:
        print("no --base config given", file=sys.stderr)
        return 2
    config: Config = Config.wrap({})
    for b in bases:
        config = merge_configs(config, load_config(b))
    config = apply_dot_overrides(config, unknown)

    model_cfg = config["model"]
    target = model_cfg["target"]
    if "autoencoder" in target.lower() or target.endswith("AutoencoderKL"):
        raise NotImplementedError(f"{target}: stage-1 (VAE-GAN) training is not ported yet "
                                  f"(ROADMAP Queue 1 item 10)")

    logdir = build_logdir(opt, now)
    ckptdir = os.path.join(logdir, "checkpoints")
    cfgdir = os.path.join(logdir, "configs")
    np.random.seed(opt.seed)
    data_cfg = config["data"]
    lightning_cfg = config.get("lightning", Config.wrap({}))

    datamodule = instantiate_from_config(data_cfg)
    datamodule.setup()
    lr = scaled_lr(opt, opt.devices or 1, data_cfg["params"]["batch_size"],
                   float(model_cfg.get("base_learning_rate", 1e-4)))

    from versband_tpu_torch.train.callbacks import DeviceStatsCallback, SetupCallback
    from versband_tpu_torch.train.checkpoints import CheckpointManager
    from versband_tpu_torch.train.trainer import CFMTrainer

    callbacks = [SetupCallback(bool(opt.resume), now, logdir, ckptdir, cfgdir, config,
                               lightning_cfg), DeviceStatsCallback()]
    for name, cb_cfg in (lightning_cfg.get("callbacks") or {}).items():
        try:
            callbacks.append(instantiate_from_config(cb_cfg, device=device))
        except Exception as e:
            print(f"callback {name} unavailable: {e}")

    ckpt = CheckpointManager(ckptdir, monitor=model_cfg.get("params", {}).get("monitor"),
                             every_n_train_steps=10000)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(opt.seed)  # the DiT and first-stage init
        cfm = instantiate_from_config(model_cfg, device=device)
    fs_cfg = model_cfg["params"].get("first_stage_config") or {}
    load_first_stage(cfm, (fs_cfg.get("params") or {}).get("ckpt_path"))
    trainer = CFMTrainer(
        cfm, cfm.cond_stage, learning_rate=lr,
        use_ema=bool(model_cfg["params"].get("use_ema", False)),
        steps_per_call=opt.steps_per_call, prefetch_groups=opt.prefetch_groups,
        transfer_dtype=opt.transfer_dtype, caption_cache_dir=opt.caption_cache_dir,
        accumulate_grad_batches=opt.accumulate_grad_batches, logdir=logdir,
        max_steps=opt.max_steps, max_epochs=opt.max_epochs, callbacks=callbacks, ckpt=ckpt,
        seed=opt.seed)
    if run is not None:
        run.update(trainer=trainer, config=config, logdir=logdir)

    if opt.train:
        trainer.fit(datamodule, resume=bool(opt.resume))
        if not opt.no_test:
            try:
                trainer.test(datamodule)
            except Exception as e:
                print(f"test pass skipped: {e}")
    return 0


def load_first_stage(cfm, ckpt_path: Optional[str]) -> bool:
    """Load the frozen first stage from ``ckpt_path`` where it exists; False,
    and a random init, where it does not."""
    from versband_tpu_torch.train.checkpoints import load_model_checkpoint

    if ckpt_path and os.path.exists(ckpt_path):
        load_model_checkpoint(cfm.first_stage, ckpt_path)
        print(f"Restored first stage from {ckpt_path}")
        return True
    print("First stage: random init (no ckpt_path found)")
    return False


if __name__ == "__main__":
    raise SystemExit(main())
