"""The training loops (port of ``versband_tpu/train/trainer.py``:
``pad_batch_time``, ``BaseTrainer``, ``VAETrainer`` and ``CFMTrainer``).

``VAETrainer`` trains stage 1, the VAE-GAN of ``configs/ae_accomp.yaml``, on
the VAE's device: the generator (``AutoencoderKL``) and the loss module
(``VAEGANLoss``: the discriminator and ``logvar``) each under its own Adam
(0.5, 0.9) state; batches padded to the time bucket; validation
(``val/rec_loss``, ``val/kl_loss``, ``val/mse``) every ``val_every_n_epochs``
epochs into ``save_monitored``; ``last`` as a ``{"gen", "disc", "step"}``
pair at every epoch end and on SIGUSR1; ``log_images`` (inputs,
reconstructions, prior samples) for the logging callbacks; ``test`` saves
each test item's reconstruction.

``CFMTrainer`` trains the flow-matching backbone over frozen-VAE latents
(``configs/vocal2music.yaml``) on the CFM's device:

* batches are padded to a time-bucket multiple, and ``scale_by_std`` is
  computed from the first batch;
* captions go through the CFM's frozen caption tower (``cond_stage``) on the
  device, each distinct string of a step or a group once, padded to a
  power-of-two count; an opt-in cache keeps the embeddings in memory and on
  disk (``caption_cache_dir``). With ``cond_stage=None`` captions arrive as
  embeddings. The tower stays frozen: the train state wraps ``cfm.model``
  only;
* ``steps_per_call`` > 1 fuses that many steps into one call of
  :func:`versband_tpu_torch.train.step.make_cfm_multi_step`, with an early
  flush when a padded shape changes or at ``max_steps``;
* ``prefetch_groups`` > 0 assembles the next step or group (the tower, the
  stacking, the host-to-device copies) on a worker thread while the card
  runs the current one. It works on the same stream, so the card keeps the
  order; copies come from pinned memory, so they do not wait for the card;
* ``transfer_dtype="float16"`` sends mels as fp16 (ids always go as int16),
  widened back on the card;
* validation every ``val_every_n_epochs`` epochs runs the model in eval
  routing (no Gumbel noise) with the EMA weights when ``use_ema``, from a
  generator seeded per batch index, and feeds ``save_monitored``;
* ``last`` (with ``scale_factor`` in ``last_step.json``) is saved at every
  epoch end and on SIGUSR1; ``log_images`` samples and decodes for the
  logging callbacks, and ``test`` saves a sample per test item.

Under a process group (``versband_tpu_torch.parallel``, one rank per card)
both trainers start every rank from rank 0's weights, draw from a generator
seeded ``seed + d`` (d: the rank's data index), and step on the gradients
averaged over the data axis; rank 0 alone writes checkpoints, metric logs
and TensorBoard (the CLI gives the logging callbacks to rank 0 only), and
every rank reads the checkpoint on resume. Validation runs each data index's
shard, validation batch i of data index d seeded as global batch ``d + i x
n_data``, and the sums of the losses and counts are all-reduced over the
data axis, so the logged value is the one-rank value when the batches
divide evenly. ``scale_by_std`` takes the std over the global first batch.

``CFMTrainer(mesh=...)`` adds the ``model`` axis (``parallel.mesh``): the
backbone is cut to each rank's heads and experts (``parallel.sharding``)
when the state is made, the ranks of one model row draw alike (their
generator's seed is the data index's), and a checkpoint is whole: every rank
gathers, rank 0 writes the file a one-process run writes. ``VAETrainer``
keeps the data axis only, as JAX does.

Both trainers' spans (``utils/profiling.py``): ``data.loader.next`` around
each fetch of a batch, ``train.log_metrics``, ``train.callbacks`` around a
callback dispatch; ``CFMTrainer`` adds ``train.assemble`` (a step's or a
group's device batch, on the prefetch thread where there is one) and
``train.prefetch.wait`` (waiting for it). The steps' own spans are in
``train/step.py`` and ``train/vae_step.py``.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import os
import signal
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from versband_tpu_torch import parallel
from versband_tpu_torch.data.collate import pad_or_cut_xd
from versband_tpu_torch.models.cfm import CFM, cfm_p_losses
from versband_tpu_torch.parallel.sharding import shard_module_
from versband_tpu_torch.train.callbacks import Callback
from versband_tpu_torch.train.checkpoints import CheckpointManager
from versband_tpu_torch.train.state import TrainState, ema_scope, make_adam, make_adamw
from versband_tpu_torch.train.step import (_decompress_batch, make_cfm_multi_step,
                                           make_cfm_train_step)
from versband_tpu_torch.train.vae_step import (make_vae_eval_step, make_vae_train_step,
                                               vae_forward)
from versband_tpu_torch.utils.config import instantiate_from_config
from versband_tpu_torch.utils.profiling import annotate

MIDI_PAD, BEATS_PAD = 128, 2
VAL_SEED = 17  # validation batch i draws from a generator seeded VAL_SEED * 2**32 + i
# (i counts the global batches: data index d's j-th is d + j x n_data)


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


def _pow2_at_least(n: int) -> int:
    bucket = 1
    while bucket < n:
        bucket *= 2
    return bucket


class BaseTrainer:
    def __init__(self, logdir: str, max_steps: int = 10 ** 9, max_epochs: int = 10 ** 6,
                 val_every_n_epochs: int = 1, log_every_n_steps: int = 50,
                 callbacks: Optional[List[Callback]] = None,
                 ckpt: Optional[CheckpointManager] = None, seed: int = 0,
                 time_bucket: int = 128, use_tensorboard: bool = True, mesh=None):
        self.logdir = logdir
        self.max_steps = max_steps
        self.max_epochs = max_epochs
        self.val_every_n_epochs = val_every_n_epochs
        self.log_every_n_steps = log_every_n_steps
        self.callbacks = callbacks or []
        self.ckpt = ckpt or CheckpointManager(os.path.join(logdir, "checkpoints"))
        self.seed = seed
        self.time_bucket = time_bucket
        self.global_step = 0
        self.world, self.rank = parallel.world()
        self.is_main = self.rank == 0  # the rank that writes logs and checkpoints
        # the data axis: the mesh's, else every rank of the group
        self.mesh = mesh
        self.n_data, self.data_rank = ((mesh.n_data, mesh.data_rank) if mesh is not None
                                       else (self.world, self.rank))
        self.data_group = None if mesh is None else mesh.data_group
        self.writer = None
        if use_tensorboard and self.is_main:
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
        with annotate("train.log_metrics"):
            eval_call = any(str(k).startswith(("val", "test")) for k in [prefix, *metrics])
            if not self.is_main or (step % self.log_every_n_steps and not eval_call):
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

    def _val_generator(self, i: int) -> torch.Generator:
        """The generator of this rank's validation batch ``i``."""
        return torch.Generator(device=self.device).manual_seed(
            VAL_SEED * 2 ** 32 + self.data_rank + i * self.n_data)

    def _global_means(self, values: Dict[str, List[float]]) -> Dict[str, float]:
        """Each list's mean over the batches of every data index (one
        all-reduce of the sums and the count over the data axis)."""
        if not parallel.active():
            return {k: float(np.mean(v)) for k, v in values.items()}
        n = len(next(iter(values.values()), []))
        sums = torch.tensor([sum(v) for v in values.values()] + [n], dtype=torch.float64,
                            device=self.device)
        sums = parallel.global_sum(sums, self.data_group)
        return {k: float(sums[j] / sums[-1]) for j, k in enumerate(values)}

    def _dispatch(self, fn_name: str, *args):
        with annotate("train.callbacks"):
            for cb in self.callbacks:
                getattr(cb, fn_name)(self, *args)

    @staticmethod
    def _batches(loader):
        """The loader's batches, each fetch inside a ``data.loader.next`` span."""
        it = iter(loader)
        while True:
            with annotate("data.loader.next"):
                batch = next(it, None)
            if batch is None:
                return
            yield batch


class _Whole:
    """A state dict gathered already, as a checkpoint's ``state_dict()``."""

    def __init__(self, sd: dict):
        self.sd = sd

    def state_dict(self) -> dict:
        return self.sd


class _StatePair:
    """Stage 1's two train states as one checkpoint: ``{"gen", "disc",
    "step"}``."""

    def __init__(self, trainer: "VAETrainer"):
        self.trainer = trainer

    def state_dict(self) -> dict:
        t = self.trainer
        return {"gen": t.gen_state.state_dict(), "disc": t.disc_state.state_dict(),
                "step": t.global_step}

    def load_state_dict(self, sd: dict) -> None:
        self.trainer.gen_state.load_state_dict(sd["gen"])
        self.trainer.disc_state.load_state_dict(sd["disc"])


class VAETrainer(BaseTrainer):
    """Stage-1 trainer (``AutoencoderKL.training_step`` semantics) on the
    VAE's device. ``loss`` is a :class:`VAEGANLoss` on the same device.
    Posterior and prior draws come from a generator seeded with ``seed``;
    validation batch i draws from one seeded ``VAL_SEED * 2**32 + i``, so the
    metric is comparable across epochs."""

    def __init__(self, vae, loss, learning_rate: float, accumulate_grad_batches: int = 1, **kw):
        super().__init__(**kw)
        if self.mesh is not None and self.mesh.n_model > 1:
            raise ValueError("stage 1 trains over the data axis only (n_model 1), as JAX does")
        self.vae = vae
        self.loss = loss
        self.device = next(vae.parameters()).device
        self.accumulate_grad_batches = max(1, int(accumulate_grad_batches))
        self.tx = make_adam(learning_rate, betas=(0.5, 0.9),
                            accumulate_grad_batches=self.accumulate_grad_batches)
        self.train_step = make_vae_train_step(vae, loss)
        self.eval_step = make_vae_eval_step(vae, loss)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed + self.rank)
        parallel.broadcast_params(vae)
        parallel.broadcast_params(loss)
        self.gen_state = TrainState(vae, self.tx)
        self.disc_state = TrainState(loss, self.tx)
        self._pair = _StatePair(self)

    def _put(self, a) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def save_checkpoint(self, name: str = "last"):
        if self.is_main:
            self.ckpt.save_last(self._pair, self.global_step)

    def _restore(self):
        if self.ckpt.restore_last(self._pair) is None:
            return
        self.global_step = self.ckpt.last_step()
        print(f"Resumed at step {self.global_step}")

    def fit(self, datamodule, resume: bool = False):
        self._dispatch("on_fit_start")
        train_loader = datamodule.train_dataloader()
        try:
            val_loader = datamodule.val_dataloader()
        except Exception:
            val_loader = None
        if resume:
            self._restore()
        try:
            for epoch in range(self.max_epochs):
                self._dispatch("on_epoch_start", epoch)
                for batch in self._batches(train_loader):
                    batch = pad_batch_time(batch, self.time_bucket)
                    metrics = self.train_step(self.gen_state, self.disc_state,
                                              {"image": self._put(batch["image"])},
                                              self.generator)
                    self.global_step += 1  # on the host: no read of the card per step
                    self.log_metrics(metrics, self.global_step, "train/")
                    self._dispatch("on_train_batch_end", batch, metrics, self.global_step)
                    if self._sig_save:
                        self.save_checkpoint("last")
                        self._sig_save = False
                    if self.global_step >= self.max_steps:
                        break
                self._dispatch("on_epoch_end", epoch)
                if val_loader and (epoch + 1) % self.val_every_n_epochs == 0:
                    self._validate(val_loader)  # the first after N epochs
                self.save_checkpoint("last")
                if self.global_step >= self.max_steps:
                    break
        except KeyboardInterrupt:
            self._dispatch("on_exception")
            raise

    def _validate(self, val_loader) -> Dict[str, float]:
        """The mean of each eval metric over the validation batches, logged
        and handed to ``save_monitored``; read back once, at the end."""
        vals = []
        for i, vb in enumerate(val_loader):
            mel = self._put(pad_batch_time(vb, self.time_bucket)["image"])
            vals.append(self.eval_step({"image": mel}, self._val_generator(i)))
        agg = self._global_means({k: torch.stack([v[k] for v in vals]).cpu().tolist()
                                  for k in vals[0]}) if vals else {}
        self.log_metrics(agg, self.global_step, "")
        if self.is_main:
            self.ckpt.save_monitored(self._pair, self.global_step, agg)
        return agg

    def test(self, datamodule):
        """Reconstruction MSE over the test split and each item's
        reconstruction as ``<logdir>/output_imgs/fake_class/<name>.npy``."""
        try:
            loader = datamodule.test_dataloader()
        except Exception:
            print("no test split configured")
            return {}
        savedir = os.path.join(self.logdir, "output_imgs", "fake_class")
        os.makedirs(savedir, exist_ok=True)
        mses, count = [], 0
        with torch.no_grad():
            for batch in loader:
                batch = pad_batch_time(batch, self.time_bucket)
                mel = self._put(batch["image"])
                recon = vae_forward(self.vae, mel, self.generator)[0]
                mses.append(float(((recon - mel) ** 2).mean()))
                names = batch.get("f_name") or batch.get("name") or \
                    [str(count + i) for i in range(mel.shape[0])]
                recon = recon.float().cpu().numpy()
                for b, name in enumerate(names):
                    s = str(name)  # a trailing _<n> is dropped where there is one
                    base = s[: s.rfind("_")] if "_" in s else s
                    np.save(os.path.join(savedir, f"{base}.npy"), recon[b])
                    count += 1
        metrics = self._global_means({"test/mse_loss": mses}) if mses else {"test/mse_loss": 0.0}
        self.log_metrics(metrics, self.global_step, "")
        print(f"test: {count} reconstructions -> {savedir}, "
              f"mse={metrics['test/mse_loss']:.5f}")
        return metrics

    @torch.no_grad()
    def log_images(self, batch) -> Dict[str, np.ndarray]:
        """The batch's mels, their reconstructions and decodes of prior
        draws z ~ N(0, 1) at the posterior's shape, for the logging
        callbacks."""
        mel = self._put(batch["image"])
        recon, posterior = vae_forward(self.vae, mel, self.generator)
        z = torch.randn(posterior.mode().shape, generator=self.generator, device=self.device)
        samples = self.vae.decode(z)
        return {"inputs": mel.cpu().numpy(), "reconstructions": recon.float().cpu().numpy(),
                "samples": samples.float().cpu().numpy()}


class CFMTrainer(BaseTrainer):
    """Stage-2 trainer: the CFM loss over frozen-VAE latents with caption,
    midi and beats conditioning, on ``cfm.device``. ``cond_stage`` is the
    frozen caption tower (``cfm.cond_stage``), or None for batches whose
    captions are embeddings already. ``use_ema`` and ``scheduler`` default to
    the CFM's ``use_ema`` and ``scheduler_config`` (``model.params`` of the
    YAML)."""

    def __init__(self, cfm: CFM, cond_stage, learning_rate: float, grad_clip: float = 1.0,
                 use_ema: Optional[bool] = None, scheduler=None,
                 accumulate_grad_batches: int = 1, steps_per_call: int = 1,
                 prefetch_groups: int = 1, transfer_dtype: Optional[str] = None,
                 caption_cache_dir: Optional[str] = None, **kw):
        super().__init__(**kw)
        if use_ema is None:
            use_ema = cfm.use_ema
        if scheduler is None and cfm.scheduler_config:
            scheduler = instantiate_from_config(cfm.scheduler_config)
        self.cfm = cfm
        self.cond_stage = cond_stage
        self.device = cfm.device
        self.accumulate_grad_batches = max(1, int(accumulate_grad_batches))
        lr = learning_rate if scheduler is None else (
            lambda step: float(np.float32(learning_rate) * np.float32(scheduler(step))))
        self.tx = make_adamw(lr, grad_clip=grad_clip,
                             accumulate_grad_batches=self.accumulate_grad_batches)
        self.use_ema = use_ema
        self.train_step = make_cfm_train_step(
            cfm, accumulate_grad_batches=self.accumulate_grad_batches)
        self.steps_per_call = max(1, int(steps_per_call))
        self.multi_step = (make_cfm_multi_step(
            cfm, accumulate_grad_batches=self.accumulate_grad_batches)
            if self.steps_per_call > 1 else None)
        # the ranks of one model row draw alike: t, noise, posterior, Gumbel
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed + self.data_rank)
        self.state: Optional[TrainState] = None
        self._group: list = []
        self._prefetch = max(0, int(prefetch_groups))
        self._xfer_pool: Optional[ThreadPoolExecutor] = None
        self._inflight: list = []
        self._fed_steps = 0
        if transfer_dtype not in (None, "float16"):
            raise ValueError(f"transfer_dtype must be None or 'float16', not {transfer_dtype!r}")
        self.transfer_dtype = transfer_dtype
        # The embedding cache is opt-in: it pays only where the caption set
        # is small and fixed. The shipped dataset draws its captions from
        # randomised templates on every access, so the cache would rarely
        # hit. 'auto' puts it under the run's logdir (one tower per logdir).
        if caption_cache_dir == "auto":
            caption_cache_dir = os.path.join(self.logdir, "caption_cache")
        self._cap_cache_dir = caption_cache_dir if cond_stage is not None else None
        self._cap_cache: Dict[str, torch.Tensor] = {}  # caption -> [L, D] row on the device
        self._cap_cache_cap = 4096
        self._cap_lock = threading.Lock()  # the prefetch thread and log_images share it
        # miss rows written to the disk tier one group later, when their
        # values are long computed
        self._cap_pending: list = []
        if self._cap_cache_dir is not None:
            os.makedirs(self._cap_cache_dir, exist_ok=True)

    # --- captions ----------------------------------------------------------
    def _tower(self, caps: List[str]) -> torch.Tensor:
        out = self.cond_stage({"caption": list(caps), "acoustic": {}})["caption"]
        return torch.as_tensor(out, device=self.device)

    def _cache_path(self, cap: str) -> str:
        return os.path.join(self._cap_cache_dir, hashlib.sha1(cap.encode()).hexdigest() + ".npy")

    def _cache_lookup(self, cap: str) -> Optional[torch.Tensor]:
        """The row of ``cap`` on the device, or None; a disk hit is copied to
        the card once per process."""
        with self._cap_lock:
            hit = self._cap_cache.get(cap)
        if hit is not None or self._cap_cache_dir is None:
            return hit
        path = self._cache_path(cap)
        if os.path.exists(path):
            try:
                hit = torch.from_numpy(np.load(path)).to(self.device)
            except Exception:
                return None  # a torn write of a crashed run: encode again
            self._cache_remember(cap, hit)
        return hit

    def _cache_remember(self, cap: str, emb: torch.Tensor) -> None:
        with self._cap_lock:
            if len(self._cap_cache) >= self._cap_cache_cap:
                self._cap_cache.pop(next(iter(self._cap_cache)))
            self._cap_cache[cap] = emb

    def _cache_flush_pending(self) -> None:
        """Write earlier groups' miss rows to the disk tier."""
        pending, self._cap_pending = self._cap_pending, []
        for texts, enc in pending:
            arr = enc[: len(texts)].float().cpu().numpy()
            for t, e in zip(texts, arr):
                path = self._cache_path(t)
                tmp = f"{path}.tmp{os.getpid()}.npy"  # np.save appends .npy otherwise
                try:
                    np.save(tmp, e)
                    os.replace(tmp, path)  # atomic: concurrent runs are safe
                except OSError:
                    pass  # a failed cache write must never stop training

    def _encode_captions(self, batch) -> torch.Tensor:
        captions = batch["caption"]["caption"]
        if self.cond_stage is None:  # embeddings already
            return self._put(captions)
        return self._encode_caption_list(list(captions))

    def _encode_caption_list(self, caps: List[str]) -> torch.Tensor:
        """The frozen tower's embeddings of ``caps``, each distinct string
        encoded once (the tower is row-independent: max-length padding, an
        all-ones mask) and the rows gathered back; the distinct strings are
        padded to a power-of-two count, which bounds the shapes the tower
        sees. With the cache, only the misses go through the tower."""
        n = len(caps)
        if self._cap_cache_dir is not None or n > 1:
            idx_of: Dict[str, int] = {}
            inv = np.empty((n,), np.int64)
            uniq: List[str] = []
            for i, c in enumerate(caps):
                j = idx_of.setdefault(c, len(uniq))
                if j == len(uniq):
                    uniq.append(c)
                inv[i] = j
            inv_t = torch.from_numpy(inv).to(self.device)
            if self._cap_cache_dir is not None:
                self._cache_flush_pending()
                rows = [self._cache_lookup(c) for c in uniq]
                miss = [k for k, r in enumerate(rows) if r is None]
                if miss:
                    texts = [uniq[k] for k in miss]
                    padded = texts + [texts[-1]] * (_pow2_at_least(len(texts)) - len(texts))
                    enc = self._tower(padded)
                    self._cap_pending.append((texts, enc))
                    for pos, k in enumerate(miss):
                        rows[k] = enc[pos]
                        self._cache_remember(uniq[k], rows[k])
                    if len(miss) == len(uniq):  # a cold group: one gather
                        return enc[: len(miss)][inv_t]
                return torch.stack(rows)[inv_t]
            bucket = _pow2_at_least(len(uniq))
            if bucket < n:
                uniq = uniq + [uniq[-1]] * (bucket - len(uniq))
                return self._tower(uniq)[inv_t]
        return self._tower(caps)

    # --- batches -----------------------------------------------------------
    def _compress(self, a) -> np.ndarray:
        """Ids always go as int16 (midi vocabulary 130, beats 3: exact);
        float32 arrays go as fp16 under ``transfer_dtype='float16'``."""
        arr = np.asarray(a)
        if arr.dtype in (np.int32, np.int64):
            return arr.astype(np.int16)
        if self.transfer_dtype is not None and arr.dtype == np.float32:
            return arr.astype(np.float16)
        return arr

    def _put(self, a) -> torch.Tensor:
        """A host array on the device, wire-compressed; on the card the copy
        goes from pinned memory and does not wait for queued work."""
        t = torch.from_numpy(np.ascontiguousarray(self._compress(a)))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        ac = batch["caption"]["acoustic"]
        return {"image": self._put(batch["image"]), "caption": self._encode_captions(batch),
                "midi": self._put(ac["midi"]), "beats": self._put(ac["beats"])}

    def _assemble_group(self, group) -> Dict[str, torch.Tensor]:
        """One fused K-step batch, ``[K, ...]``: one tower call for all K
        batches' captions."""
        K = len(group)
        if self.cond_stage is None:
            caption = self._put(np.stack([np.asarray(b["caption"]["caption"]) for b in group]))
        else:
            enc = self._encode_caption_list(
                [c for b in group for c in list(b["caption"]["caption"])])
            caption = enc.reshape((K, -1) + tuple(enc.shape[1:]))
        return {"image": self._put(np.stack([b["image"] for b in group])),
                "caption": caption,
                "midi": self._put(np.stack([b["caption"]["acoustic"]["midi"] for b in group])),
                "beats": self._put(np.stack([b["caption"]["acoustic"]["beats"] for b in group]))}

    def _row_batch(self, batch):
        """Under a model axis, the batch of the model row's first rank on
        every rank of the row: the sampler gives them the same items, but
        the datasets' own draws (crop, caption) are not seeded alike
        (ROADMAP Queue 3), and the row's slices must see one batch."""
        if self.mesh is None or self.mesh.n_model == 1:
            return batch
        return parallel.broadcast_object(batch, self.mesh.model_group)

    def _pad(self, batch) -> Dict[str, Any]:
        ac = batch["caption"]["acoustic"]
        padded = pad_batch_time({"image": batch["image"], "midi": ac["midi"],
                                 "beats": ac["beats"]}, self.time_bucket)
        return {**batch, "image": padded["image"],
                "caption": {**batch["caption"],
                            "acoustic": {**ac, "midi": padded["midi"], "beats": padded["beats"]}}}

    # --- state -------------------------------------------------------------
    def init_state(self, example_batch: Dict[str, Any]):
        """The train state around the backbone (the tower and the VAE stay
        frozen), and scale_by_std from the first batch (when the factor is
        still the default 1.0)."""
        parallel.broadcast_params(self.cfm.model, None if self.mesh is None else self.mesh.group)
        if self.mesh is not None:
            shard_module_(self.cfm.model, self.mesh)
        self.state = TrainState(self.cfm.model, self.tx,
                                ema_decay=0.9999 if self.use_ema else None)
        if self.cfm.scale_by_std and self.cfm.scale_factor == 1.0:
            mel = _decompress_batch({"image": self._put(example_batch["image"])})["image"]
            self.cfm.compute_scale_factor(mel, self.generator, group=self.data_group)
            print(f"setting scale_factor to {self.cfm.scale_factor:.5f}")

    def _snapshot(self):
        """What a checkpoint writes of the state: under a cut backbone the
        whole state, gathered by every rank (a collective); else the state."""
        if self.state.layout is None or self.mesh.n_model == 1:
            return self.state
        return _Whole(self.state.state_dict())

    def save_checkpoint(self, name: str = "last"):
        snap = self._snapshot()
        if self.is_main:
            self.ckpt.save_last(snap, self.global_step,
                                extra={"scale_factor": self.cfm.scale_factor})
        return snap

    def _restore(self):
        if self.ckpt.restore_last(self.state) is None:
            return
        meta = self.ckpt.last_meta()
        self.global_step = int(meta.get("step", 0))
        self._fed_steps = self.global_step
        if "scale_factor" in meta:  # over the value recomputed from this run's first batch
            self.cfm.scale_factor = float(meta["scale_factor"])
        print(f"Resumed at step {self.global_step}")

    # --- the loop ----------------------------------------------------------
    def fit(self, datamodule, resume: bool = False):
        self._dispatch("on_fit_start")
        train_loader = datamodule.train_dataloader()
        try:
            val_loader = datamodule.val_dataloader()
        except Exception:
            val_loader = None
        self._fed_steps = self.global_step
        if self._prefetch and self._xfer_pool is None:
            self._xfer_pool = ThreadPoolExecutor(self._prefetch, thread_name_prefix="cfm-xfer")
        try:
            for epoch in range(self.max_epochs):
                self._dispatch("on_epoch_start", epoch)
                for batch in self._batches(train_loader):
                    batch = self._pad(self._row_batch(batch))
                    if self.state is None:
                        self.init_state(batch)
                        if resume:
                            self._restore()
                    # a group is stacked: flush early when a padded shape changes
                    if (self.steps_per_call > 1 and self._group
                            and self._group_sig(self._group[0]) != self._group_sig(batch)):
                        self._flush_group()
                    self._group.append(batch)
                    # never fuse past max_steps: global_step lands on it exactly
                    if (len(self._group) >= self.steps_per_call
                            or self._fed_steps + len(self._group) >= self.max_steps):
                        self._flush_group()
                        if self._fed_steps >= self.max_steps:
                            self._drain()
                    if self._sig_save:
                        self._drain()
                        self.save_checkpoint("last")
                        self._sig_save = False
                    if self.global_step >= self.max_steps:
                        break
                self._flush_group()
                self._drain()
                self._dispatch("on_epoch_end", epoch)
                if self.state is not None:
                    if val_loader and (epoch + 1) % self.val_every_n_epochs == 0:
                        self._validate(val_loader)  # the first after N epochs
                    snap = self.save_checkpoint("last")
                    if self.is_main:
                        self.ckpt.save_step_archive(snap, self.global_step)
                if self.global_step >= self.max_steps:
                    break
        except KeyboardInterrupt:
            self._dispatch("on_exception")
            raise
        finally:
            if self._xfer_pool is not None:
                self._xfer_pool.shutdown(wait=False, cancel_futures=True)
                self._xfer_pool = None
                self._inflight.clear()
            if self._cap_pending:
                self._cache_flush_pending()

    def _group_sig(self, batch):
        """The shapes a fused group must share to be stacked."""
        cap = batch["caption"]["caption"]
        return (np.shape(batch["image"]),
                np.shape(cap) if self.cond_stage is None else None,
                np.shape(batch["caption"]["acoustic"]["midi"]))

    def _flush_group(self):
        """Hand the buffered batches to the prefetch thread (or run them)."""
        group, self._group = self._group, []
        if not group:
            return
        self._fed_steps += len(group)
        if len(group) == 1:
            def assemble():
                with annotate("train.assemble"):
                    return self._device_batch(group[0])

            def dispatch(db):
                self._dispatch_single(db, group[0])
        else:
            def assemble():
                with annotate("train.assemble"):
                    return self._assemble_group(group)

            def dispatch(db):
                self._dispatch_group(db, group)
        if self._xfer_pool is None:
            dispatch(assemble())
            return
        self._inflight.append((self._xfer_pool.submit(assemble), dispatch))
        while len(self._inflight) > self._prefetch:
            self._dispatch_next()

    def _dispatch_next(self):
        fut, dispatch = self._inflight.pop(0)
        with annotate("train.prefetch.wait"):
            db = fut.result()
        dispatch(db)

    def _drain(self):
        """Run every assembled step or group still waiting (global_step
        catches up with the steps fed)."""
        while self._inflight:
            self._dispatch_next()

    def _dispatch_single(self, db: Dict[str, torch.Tensor], batch):
        metrics = self.train_step(self.state, db, self.generator)
        self.global_step += 1
        self.log_metrics(metrics, self.global_step, "train/")
        self._dispatch("on_train_batch_end", batch, metrics, self.global_step)

    def _dispatch_group(self, db: Dict[str, torch.Tensor], group):
        ms = self.multi_step(self.state, db, self.generator)
        self.global_step += len(group)
        last = {k: v[-1] for k, v in ms.items()}
        self.log_metrics(last, self.global_step, "train/")
        # callbacks fire once per group, with its last batch and metrics
        self._dispatch("on_train_batch_end", group[-1], last, self.global_step)

    # --- sampling, test, validation ------------------------------------------
    def log_images(self, batch) -> Dict[str, np.ndarray]:
        """The first (up to 4) ground-truth mels of ``batch`` and CFM samples
        (scale 1, 25 steps) decoded by the VAE, for the logging callbacks."""
        if self.state is None:
            return {}
        db = _decompress_batch(self._device_batch(batch))
        B = min(int(db["image"].shape[0]), 4)
        cond = {"caption": db["caption"][:B],
                "acoustic": {"midi": db["midi"][:B], "beats": db["beats"][:B]}}
        z = self.cfm.sample_cfg(cond, 1.0, None, self.generator, batch_size=B)
        mel = self.cfm.decode_first_stage(z)
        return {"inputs": db["image"][:B].float().cpu().numpy(),
                "samples": mel.float().cpu().numpy()}

    def test(self, datamodule):
        """Sample and decode per test item, saving mels under
        ``<logdir>/output_samples``."""
        try:
            loader = datamodule.test_dataloader()
        except Exception:
            print("no test split configured")
            return {}
        savedir = os.path.join(self.logdir, "output_samples")
        os.makedirs(savedir, exist_ok=True)
        count = 0
        for batch in loader:
            images = self.log_images(self._row_batch(batch))  # a cut backbone samples together
            for b in range(images["samples"].shape[0]):
                tag = f"sample_{count:05d}" if self.n_data == 1 else \
                    f"rank{self.data_rank}_sample_{count:05d}"  # each data index its shard
                if self.mesh is None or self.mesh.model_rank == 0:
                    np.save(os.path.join(savedir, f"{tag}.npy"), images["samples"][b])
                count += 1
        print(f"test: {count} samples -> {savedir}")
        return {"test/num_samples": count}

    @torch.no_grad()
    def _val_loss(self, db: Dict[str, torch.Tensor], generator: torch.Generator,
                  given: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """The CFM loss of one validation batch in eval routing: the
        posterior draw, t and the noise from ``generator`` (or ``given``)."""
        given = given or {}
        cfm = self.cfm
        z = cfm.encode_first_stage(db["image"], generator, noise=given.get("posterior"))
        t = given.get("t")
        if t is None:
            t = torch.randint(0, cfm.num_timesteps, (z.shape[0],), generator=generator,
                              device=z.device)
        noise = given.get("noise")
        if noise is None:
            noise = torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)
        cond = {"caption": db["caption"], "acoustic": {"midi": db["midi"], "beats": db["beats"]}}
        _, parts = cfm_p_losses(cfm.model, z, cond, t, noise, sigma_min=cfm.sigma_min,
                                num_timesteps=cfm.num_timesteps,
                                l_simple_weight=cfm.l_simple_weight, gumbel=None)
        return parts

    def _validate(self, val_loader):
        """``val/loss_simple`` (``_ema`` with EMA weights): the mean over the
        validation batches of the flow-matching loss, without the MoE
        load-balance term. Batch i draws from a generator seeded
        ``VAL_SEED * 2**32 + i``, so the metric is comparable across
        epochs. The losses are read back once, at the end."""
        losses = []
        scope = ema_scope(self.state) if self.use_ema else contextlib.nullcontext()
        with scope:
            for i, vb in enumerate(val_loader):
                db = _decompress_batch(self._device_batch(self._pad(self._row_batch(vb))))
                losses.append(self._val_loss(db, self._val_generator(i))["loss_simple"])
        suffix = "_ema" if self.use_ema else ""
        key = f"val/loss_simple{suffix}"
        agg = self._global_means({key: torch.stack(losses).cpu().tolist()})
        self.log_metrics(agg, self.global_step, "")
        snap = self._snapshot()
        if self.is_main:
            self.ckpt.save_monitored(snap, self.global_step, agg)
        return agg
