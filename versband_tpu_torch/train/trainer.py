"""The stage-2 training loop (port of ``versband_tpu/train/trainer.py``:
``pad_batch_time``, ``BaseTrainer`` and ``CFMTrainer``).

``CFMTrainer`` trains the flow-matching backbone over frozen-VAE latents
(``configs/vocal2music.yaml``) on the CFM's device: batches are padded to a
time-bucket multiple, ``scale_by_std`` is computed from the first batch,
each batch is one call of :func:`versband_tpu_torch.train.step.make_cfm_train_step`,
and ``last`` (with ``scale_factor`` in ``last_step.json``) is saved at every
epoch end and on SIGUSR1. Captions arrive pre-encoded (the text tower is not
ported yet), as the JAX trainer takes them with ``cond_stage=None``.

Not ported yet: fusing several steps into one call (``steps_per_call``), the
prefetch thread, the caption cache and dedup, ``transfer_dtype``, the mesh,
and validation, test and image logging.
"""

from __future__ import annotations

import math
import os
import signal
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from versband_tpu_torch.data.collate import pad_or_cut_xd
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.train.callbacks import Callback
from versband_tpu_torch.train.checkpoints import CheckpointManager
from versband_tpu_torch.train.state import TrainState, make_adamw
from versband_tpu_torch.train.step import make_cfm_train_step
from versband_tpu_torch.utils.config import instantiate_from_config

MIDI_PAD, BEATS_PAD = 128, 2


def pad_batch_time(batch: Dict[str, np.ndarray], multiple: int = 128,
                   pad_value: float = -5.0) -> Dict[str, np.ndarray]:
    """Pad every [B, C, T] array to the next T multiple (mels with -5, midi
    with 128, beats with 2), which bounds the set of shapes a run sees."""
    out = dict(batch)
    for key, pad in (("image", pad_value), ("acoustic", pad_value),
                     ("midi", MIDI_PAD), ("beats", BEATS_PAD)):
        if key in out and getattr(out[key], "ndim", 0) == 3:
            target = math.ceil(out[key].shape[2] / multiple) * multiple
            out[key] = pad_or_cut_xd(out[key], target, 2, pad)
    return out


class BaseTrainer:
    def __init__(self, logdir: str, max_steps: int = 10 ** 9, max_epochs: int = 10 ** 6,
                 log_every_n_steps: int = 50,
                 callbacks: Optional[List[Callback]] = None,
                 ckpt: Optional[CheckpointManager] = None, seed: int = 0,
                 time_bucket: int = 128, use_tensorboard: bool = True):
        self.logdir = logdir
        self.max_steps = max_steps
        self.max_epochs = max_epochs
        self.log_every_n_steps = log_every_n_steps
        self.callbacks = callbacks or []
        self.ckpt = ckpt or CheckpointManager(os.path.join(logdir, "checkpoints"))
        self.seed = seed
        self.time_bucket = time_bucket
        self.global_step = 0
        self.writer = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(os.path.join(logdir, "tb"))
            except Exception:  # tensorboard is optional
                self.writer = None
        self._sig_save = False
        try:
            signal.signal(signal.SIGUSR1, self._on_sigusr1)
            signal.signal(signal.SIGUSR2, self._on_sigusr2)
        except (ValueError, OSError):
            pass  # not the main thread

    def _on_sigusr1(self, *_):
        # SIGUSR1 -> checkpoint at the next batch boundary
        self._sig_save = True

    @staticmethod
    def _on_sigusr2(*_):
        # SIGUSR2 -> a debugger on a tty, else a stack dump (pdb would wedge
        # on a closed stdin)
        import sys

        try:
            interactive = sys.stdin is not None and sys.stdin.isatty()
        except (ValueError, OSError):
            interactive = False
        if interactive:
            import pdb

            pdb.set_trace()
        else:
            import traceback

            traceback.print_stack()

    def log_metrics(self, metrics: Dict[str, Any], step: int, prefix: str = ""):
        """Write scalar metrics every ``log_every_n_steps`` (val/test always);
        device tensors are read only on the steps that log."""
        eval_call = any(str(k).startswith(("val", "test")) for k in [prefix, *metrics])
        if step % self.log_every_n_steps and not eval_call:
            return
        scal = {f"{prefix}{k}": float(v) for k, v in metrics.items() if np.ndim(v) == 0}
        if self.writer is not None:
            for k, v in scal.items():
                self.writer.add_scalar(k, v, step)
        if eval_call or step % (self.log_every_n_steps * 10) == 0:
            print(f"[step {step}] " + ", ".join(f"{k}={v:.4f}" for k, v in
                                                 list(scal.items())[:6]))

    def save_checkpoint(self, name: str):
        raise NotImplementedError

    def _dispatch(self, fn_name: str, *args):
        for cb in self.callbacks:
            getattr(cb, fn_name)(self, *args)


class CFMTrainer(BaseTrainer):
    """Stage-2 trainer: the CFM loss over frozen-VAE latents with caption,
    midi and beats conditioning, on ``cfm.device``. ``use_ema`` and
    ``scheduler`` default to the CFM's ``use_ema`` and ``scheduler_config``
    (``model.params`` of the YAML)."""

    def __init__(self, cfm: CFM, cond_stage, learning_rate: float, grad_clip: float = 1.0,
                 use_ema: Optional[bool] = None, scheduler=None,
                 accumulate_grad_batches: int = 1, **kw):
        super().__init__(**kw)
        if cond_stage is not None:
            raise NotImplementedError("the text tower is not ported yet: pass captions "
                                      "as embeddings with cond_stage=None")
        if use_ema is None:
            use_ema = cfm.use_ema
        if scheduler is None and cfm.scheduler_config:
            scheduler = instantiate_from_config(cfm.scheduler_config)
        self.cfm = cfm
        self.device = cfm.device
        self.accumulate_grad_batches = max(1, int(accumulate_grad_batches))
        lr = learning_rate if scheduler is None else (
            lambda step: float(np.float32(learning_rate) * np.float32(scheduler(step))))
        self.tx = make_adamw(lr, grad_clip=grad_clip,
                             accumulate_grad_batches=self.accumulate_grad_batches)
        self.use_ema = use_ema
        self.train_step = make_cfm_train_step(
            cfm, accumulate_grad_batches=self.accumulate_grad_batches)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.state: Optional[TrainState] = None

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The step's batch on the device: the mel and caption embeddings in
        float32, midi/beats ids as int16 (value-preserving for vocabularies of
        130 and 3; the step widens them)."""
        def put(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(device=self.device, dtype=dtype)

        ac = batch["caption"]["acoustic"]
        return {"image": put(batch["image"], torch.float32),
                "caption": put(batch["caption"]["caption"], torch.float32),
                "midi": put(ac["midi"], torch.int16), "beats": put(ac["beats"], torch.int16)}

    def init_state(self, example_batch: Dict[str, Any]):
        """The train state around the backbone, and scale_by_std from the
        first batch (when the factor is still the default 1.0)."""
        self.state = TrainState(self.cfm.model, self.tx,
                                ema_decay=0.9999 if self.use_ema else None)
        if self.cfm.scale_by_std and self.cfm.scale_factor == 1.0:
            mel = self._device_batch(example_batch)["image"]
            self.cfm.compute_scale_factor(mel, self.generator)
            print(f"setting scale_factor to {self.cfm.scale_factor:.5f}")

    def save_checkpoint(self, name: str = "last"):
        self.ckpt.save_last(self.state, self.global_step,
                            extra={"scale_factor": self.cfm.scale_factor})

    def _restore(self):
        if self.ckpt.restore_last(self.state) is None:
            return
        meta = self.ckpt.last_meta()
        self.global_step = int(meta.get("step", 0))
        if "scale_factor" in meta:  # over the value recomputed from this run's first batch
            self.cfm.scale_factor = float(meta["scale_factor"])
        print(f"Resumed at step {self.global_step}")

    def fit(self, datamodule, resume: bool = False):
        self._dispatch("on_fit_start")
        train_loader = datamodule.train_dataloader()
        try:
            for epoch in range(self.max_epochs):
                self._dispatch("on_epoch_start", epoch)
                for batch in train_loader:
                    ac = batch["caption"]["acoustic"]
                    padded = pad_batch_time({"image": batch["image"], "midi": ac["midi"],
                                             "beats": ac["beats"]}, self.time_bucket)
                    batch = {**batch, "image": padded["image"],
                             "caption": {**batch["caption"],
                                         "acoustic": {**ac, "midi": padded["midi"],
                                                      "beats": padded["beats"]}}}
                    if self.state is None:
                        self.init_state(batch)
                        if resume:
                            self._restore()
                    self._dispatch_single(self._device_batch(batch), batch)
                    if self._sig_save:
                        self.save_checkpoint("last")
                        self._sig_save = False
                    if self.global_step >= self.max_steps:
                        break
                self._dispatch("on_epoch_end", epoch)
                if self.state is not None:
                    self.save_checkpoint("last")
                    self.ckpt.save_step_archive(self.state, self.global_step)
                if self.global_step >= self.max_steps:
                    break
        except KeyboardInterrupt:
            self._dispatch("on_exception")
            raise

    def _dispatch_single(self, db: Dict[str, torch.Tensor], batch):
        metrics = self.train_step(self.state, db, self.generator)
        self.global_step += 1
        self.log_metrics(metrics, self.global_step, "train/")
        self._dispatch("on_train_batch_end", batch, metrics, self.global_step)
