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

A stage-1 config (an ``AutoencoderKL`` target, ``configs/ae_accomp.yaml``)
trains the VAE-GAN with ``VAETrainer``: the VAE and its ``lossconfig``
(``VAEGANLoss``) are built from ``--seed`` on the card; any other config
trains the CFM with ``CFMTrainer``.

Data parallelism, one rank per card over NCCL (``--platform cpu``: one
process per rank over gloo), as Lightning's DDP trained the reference:

* under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node N
  -m versband_tpu_torch.cli.train ...``) each process joins the group its
  environment describes and trains on ``cuda:LOCAL_RANK``;
* ``--devices N`` without that environment starts the N ranks itself
  (``torch.multiprocessing``, a ``file://`` rendezvous in a temporary
  directory); more cards than the host has raises;
* each rank loads ``batch_size`` from its shard, so the global batch and the
  LR's ``devices`` factor are the world size; rank 0 writes the run's files.

``--n_model M`` adds tensor and expert parallelism for the CFM backbone,
whichever it is: the ranks form a ``(world / M, M)`` mesh
(``parallel.make_mesh``), as JAX ``cli/train.py:186-198`` builds it for any
``unet_config``; each model row of M ranks holds one model cut by
``parallel.sharding``'s rules (the Band-MoE DiT over its heads and experts,
the Time/Freq DiT over its heads and frequency experts, a ConcatDiT not at
all) and loads one batch, so the global batch and the LR's ``devices``
factor are ``world / M``. Checkpoints are whole, the file a one-process run
writes. Stage 1 trains over the data axis only and ignores ``--n_model``
(JAX ``cli/train.py:170-176``), and says so.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import os
import shutil
import sys
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from versband_tpu_torch import parallel
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
                   help="data-parallel ranks, one per card (CPU processes with "
                        "--platform cpu); under torchrun, its world size")
    p.add_argument("--n_model", type=int, default=1,
                   help="model axis of the (data, model) mesh: tensor parallelism over the "
                        "backbone's attention heads and expert parallelism over its experts, "
                        "as the sharding rules pick them; the ranks (--devices or "
                        "torchrun's) must divide by it; stage 1 ignores it")
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
    from versband_tpu_torch.device import resolve_device

    if opt.n_model > 1:
        check_model_axis(load_run_config(opt, unknown), opt.n_model)

    device_type = "cpu" if opt.platform == "cpu" else "cuda"
    joined = False
    if parallel.launched():
        joined = not parallel.active()
        device = resolve_device(parallel.init_from_env(device_type))
        if opt.devices not in (None, parallel.world()[0]):
            raise ValueError(f"--devices {opt.devices} differs from the launcher's world "
                             f"size {parallel.world()[0]}")
    elif (opt.devices or 1) > 1:
        return launch_ranks(sys.argv[1:] if argv is None else list(argv), opt.devices,
                           device_type)
    else:
        device = resolve_device(opt.platform)
    try:
        return _train(opt, unknown, device, run)
    finally:
        if joined:
            parallel.leave()


def load_run_config(opt, unknown: List[str]) -> Optional[Config]:
    """The run's config: ``-r``'s archived configs, then ``--base`` in order,
    then the ``key=value`` overrides; None without any config."""
    bases = list(opt.base)
    if opt.resume:
        bases = sorted(glob.glob(os.path.join(opt.resume, "configs/*.yaml"))) + bases
    if not bases:
        return None
    config: Config = Config.wrap({})
    for b in bases:
        config = merge_configs(config, load_config(b))
    return apply_dot_overrides(config, unknown)


def is_stage1(config: Config) -> bool:
    target = config["model"]["target"]
    return "autoencoder" in target.lower() or target.endswith("AutoencoderKL")


def check_model_axis(config: Optional[Config], n_model: int) -> None:
    """``--n_model`` above 1: cut the backbone, built on the meta device, as
    one rank of a ``(1, n_model)`` mesh cuts it, so that a backbone the model
    axis cannot cut (``qk_norm``; a parameter the rules pick in a module
    ``shard_module_`` does not know) raises here, before any rank starts.
    Stage 1 ignores the flag."""
    from versband_tpu_torch.parallel.mesh import Mesh
    from versband_tpu_torch.parallel.sharding import shard_module_

    if config is None or is_stage1(config):
        return
    with torch.device("meta"):
        unet = instantiate_from_config(config["model"]["params"]["unet_config"])
    shard_module_(unet, Mesh(1, n_model, 0, 0))


def _train(opt, unknown: List[str], device: torch.device,
           run: Optional[Dict[str, Any]]) -> int:
    ndev, rank = parallel.world()
    # one run directory for every rank: rank 0's clock names it
    now = parallel.broadcast_object(datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S"))

    config = load_run_config(opt, unknown)
    if config is None:
        print("no --base config given", file=sys.stderr)
        return 2
    model_cfg = config["model"]
    stage1 = is_stage1(config)
    mesh = None
    if stage1 and opt.n_model > 1:
        print(f"Stage 1 trains over the data axis only: --n_model {opt.n_model} ignored")
    elif not stage1 and (ndev > 1 or opt.n_model > 1):
        mesh = parallel.make_mesh(None, opt.n_model)
        print(f"Training on mesh {mesh.shape}")
    n_data = ndev if mesh is None else mesh.n_data
    logdir = build_logdir(opt, now)
    ckptdir = os.path.join(logdir, "checkpoints")
    cfgdir = os.path.join(logdir, "configs")
    np.random.seed(opt.seed)
    data_cfg = config["data"]
    lightning_cfg = config.get("lightning", Config.wrap({}))

    datamodule = instantiate_from_config(data_cfg)
    if mesh is not None:  # the sampler shards by data index: a model row loads one batch
        datamodule.num_replicas, datamodule.rank = mesh.n_data, mesh.data_rank
    datamodule.setup()
    lr = scaled_lr(opt, n_data, data_cfg["params"]["batch_size"],
                   float(model_cfg.get("base_learning_rate", 1e-4)))

    from versband_tpu_torch.train.callbacks import DeviceStatsCallback, SetupCallback
    from versband_tpu_torch.train.checkpoints import CheckpointManager
    from versband_tpu_torch.train.trainer import CFMTrainer, VAETrainer

    callbacks = []
    if rank == 0:  # the run's directory, configs and logs are rank 0's to write
        callbacks = [SetupCallback(bool(opt.resume), now, logdir, ckptdir, cfgdir, config,
                                   lightning_cfg), DeviceStatsCallback()]
    # the loggers sample through the backbone: under a model axis, every rank
    # of rank 0's model row runs them (rank 0 alone writes)
    if rank == 0 or (mesh is not None and mesh.n_model > 1 and mesh.data_rank == 0):
        for name, cb_cfg in (lightning_cfg.get("callbacks") or {}).items():
            try:
                callbacks.append(instantiate_from_config(cb_cfg, device=device))
            except Exception as e:
                print(f"callback {name} unavailable: {e}")

    ckpt = CheckpointManager(ckptdir, monitor=model_cfg.get("params", {}).get("monitor"),
                             every_n_train_steps=10000)
    common = dict(logdir=logdir, max_steps=opt.max_steps, max_epochs=opt.max_epochs,
                  callbacks=callbacks, ckpt=ckpt, seed=opt.seed,
                  accumulate_grad_batches=opt.accumulate_grad_batches)
    if stage1:
        trainer = VAETrainer(*build_vae_gan(model_cfg, device, opt.seed), learning_rate=lr,
                             **common)
    else:
        # the DiT and first-stage init, made on the device
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(opt.seed)
            cfm = instantiate_from_config(model_cfg, device=device)
        fs_cfg = model_cfg["params"].get("first_stage_config") or {}
        load_first_stage(cfm, (fs_cfg.get("params") or {}).get("ckpt_path"))
        trainer = CFMTrainer(
            cfm, cfm.cond_stage, learning_rate=lr,
            use_ema=bool(model_cfg["params"].get("use_ema", False)),
            steps_per_call=opt.steps_per_call, prefetch_groups=opt.prefetch_groups,
            transfer_dtype=opt.transfer_dtype, caption_cache_dir=opt.caption_cache_dir,
            mesh=mesh, **common)
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


def _spawned_rank(index: int, argv: List[str], world: int, device_type: str,
                  rendezvous: str) -> None:
    """Rank ``index`` of a run that ``--devices`` started: the environment a
    launcher would give it, the group joined through ``rendezvous``, then
    the CLI."""
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index), WORLD_SIZE=str(world))
    parallel.init_from_env(device_type, init_method=f"file://{rendezvous}")
    try:
        rc = main(argv)
    finally:
        parallel.leave()
    if rc:
        raise SystemExit(rc)


def launch_ranks(argv: List[str], world: int, device_type: str) -> int:
    """Train with ``world`` ranks started here (Lightning's DDP launch), each
    running this CLI on ``argv``; returns 0 when every rank did."""
    import torch.multiprocessing as mp

    if device_type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"--devices {world} asks for more cards than this host has "
                         f"({torch.cuda.device_count()})")
    tmp = tempfile.mkdtemp(prefix="versband_ddp_")
    try:
        mp.spawn(_spawned_rank, args=(argv, world, device_type, os.path.join(tmp, "rdzv")),
                 nprocs=world, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def build_vae_gan(model_cfg, device: torch.device, seed: int):
    """Stage 1's (VAE, VAEGANLoss) on ``device``, initialised from ``seed``;
    the YAML's ``lossconfig`` builds the loss."""
    from versband_tpu_torch.models.autoencoder import AutoencoderKL
    from versband_tpu_torch.train.gan_losses import VAEGANLoss

    params = dict(model_cfg.get("params", {}))
    loss_cfg = params.pop("lossconfig", None)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        vae = AutoencoderKL(embed_dim=params["embed_dim"], ddconfig=params.get("ddconfig"),
                            monitor=params.get("monitor"))
        loss = instantiate_from_config(loss_cfg) if loss_cfg else None
    if not isinstance(loss, VAEGANLoss):
        raise ValueError(f"stage 1 trains with a VAEGANLoss lossconfig, not {loss_cfg!r}")
    return vae.to(device), loss.to(device)


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
