"""The port's LR schedules against ``versband_tpu.train.lr_schedules``, and
its ``CFMTrainer`` loop on a tiny in-memory datamodule (CPU).

The schedules compute in float32 as XLA compiles the JAX ones inside the
jitted step, so the linear ones agree with the jitted JAX schedule exactly
(the shipped LambdaLinearScheduler's 1e13-step cycle included); the cosine
one to one float32 ulp (2.4e-7 relative: XLA's own cosine approximation
against libm's); the cyclic one, host arithmetic on both sides, exactly.
The trainer runs 3 steps, writes ``last`` with ``scale_factor`` in
``last_step.json``, and a second trainer resumes from it.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from versband_tpu.train import lr_schedules as jls
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.train import lr_schedules as tls
from versband_tpu_torch.train.callbacks import Callback
from versband_tpu_torch.train.trainer import CFMTrainer, pad_batch_time
from torch_port_helpers import DIT_TINY, VAE_TINY

SHIPPED = dict(warm_up_steps=[10000], cycle_lengths=[10000000000000], f_start=[1.0e-06],
               f_max=[1.0], f_min=[1.0])
SCHEDULES = [
    ("LambdaLinearScheduler", SHIPPED),
    ("LambdaLinearScheduler", dict(warm_up_steps=[100], cycle_lengths=[1000], f_start=[0.1],
                                   f_max=[1.0], f_min=[0.2])),
    ("LambdaWarmUpCosineScheduler", dict(warm_up_steps=100, lr_min=0.1, lr_max=1.0,
                                         lr_start=0.01, max_decay_steps=1000)),
    ("LambdaWarmUpCosineScheduler2", dict(warm_up_steps=[10, 20], f_min=[0.1, 0.2],
                                          f_max=[1.0, 0.9], f_start=[0.0, 0.05],
                                          cycle_lengths=[100, 200])),
]
STEPS = list(range(0, 1200, 7)) + [9999, 10000, 10001, 123457, 10 ** 6, 10 ** 9]


@pytest.mark.parametrize("name,cfg", SCHEDULES)
def test_lr_schedules_match_jax(name, cfg):
    ours, ref = getattr(tls, name)(**cfg), getattr(jls, name)(**cfg)
    host = name == "LambdaWarmUpCosineScheduler2"
    jitted = ref if host else jax.jit(ref)  # as the JAX train step evaluates it
    rtol = 2.4e-7 if name == "LambdaWarmUpCosineScheduler" else 0.0
    for s in STEPS:
        want = float(jitted(s))
        assert abs(ours(s) - want) <= rtol * abs(want), (s, ours(s), want)
    assert tls.scale_base_lr(3e-6, 8, 1, 2) == jls.scale_base_lr(3e-6, 8, 1, 2) == 4.8e-5
    assert tls.scale_base_lr(3e-6, 8, 4, scale=False) == 3e-6


class _Data:
    """3 batches in the shipped layout, ragged in time (30 frames)."""

    def train_dataloader(self):
        rng = np.random.default_rng(0)
        for _ in range(3):
            yield {"image": rng.standard_normal((2, 80, 30)).astype(np.float32),
                   "caption": {"caption": rng.standard_normal((2, 5, 12)).astype(np.float32),
                               "acoustic": {"midi": rng.integers(0, 128, (2, 1, 30)),
                                            "beats": rng.integers(0, 2, (2, 1, 30))}}}


class _Count(Callback):
    def __init__(self):
        self.steps = []

    def on_train_batch_end(self, trainer, batch, metrics, step):
        assert batch["image"].shape == (2, 80, 32)  # padded to the 16-frame bucket
        assert set(metrics) == {"loss", "loss_simple", "lb_loss", "grad_norm"}
        self.steps.append(step)


def _trainer(logdir, max_steps, **kw):
    torch.manual_seed(0)
    cfm = CFM(unet_config=dict(target="versband_tpu.models.dit.BandMoeDiT",
                               params={**DIT_TINY, "use_flash": True}),
              first_stage_config=dict(target="versband_tpu.models.autoencoder.AutoencoderKL",
                                      params=VAE_TINY), mel_dim=4, device="cpu")
    sched = tls.LambdaLinearScheduler(**{**SHIPPED, "warm_up_steps": [2]})
    return CFMTrainer(cfm, None, learning_rate=1e-3, scheduler=sched, logdir=str(logdir),
                      max_steps=max_steps, max_epochs=10, time_bucket=16,
                      use_tensorboard=False, log_every_n_steps=10 ** 6, seed=0, **kw)


def test_fit_checkpoint_and_resume(tmp_path):
    cb = _Count()
    tr = _trainer(tmp_path, 3, callbacks=[cb])
    before = {k: v.clone() for k, v in tr.cfm.model.state_dict().items()}
    tr.fit(_Data())
    assert tr.global_step == 3 and tr.state.step == 3 and cb.steps == [1, 2, 3]
    assert tr.cfm.scale_factor != 1.0  # scale_by_std from the first batch
    assert any((before[k] - v).abs().max() > 0 for k, v in tr.cfm.model.state_dict().items())
    ckpt = tmp_path / "checkpoints"
    assert (ckpt / "last.pt").exists()
    meta = json.loads((ckpt / "last_step.json").read_text())
    assert meta == {"step": 3, "scale_factor": tr.cfm.scale_factor}
    trained = {k: v.clone() for k, v in tr.cfm.model.state_dict().items()}

    # resume: a fresh model, a first batch that would give another scale factor
    tr2 = _trainer(tmp_path, 5)
    tr2.cfm.scale_factor = 1.0
    seen = []

    class _Check(Callback):
        def on_train_batch_end(self, trainer, batch, metrics, step):
            seen.append((step, trainer.state.step, trainer.state.updates))

    tr2.callbacks.append(_Check())
    orig = tr2.init_state

    def init_then_compare(batch):
        orig(batch)
        tr2.cfm.scale_factor = 0.5  # as if this run's first batch had set it

    tr2.init_state = init_then_compare
    restored = {}
    orig_restore = tr2._restore

    def restore_and_record():
        orig_restore()
        restored.update({k: v.clone() for k, v in tr2.cfm.model.state_dict().items()})

    tr2._restore = restore_and_record
    tr2.fit(_Data(), resume=True)
    assert tr2.cfm.scale_factor == meta["scale_factor"]
    assert seen[0] == (4, 4, 4) and tr2.global_step == 5
    assert json.loads((ckpt / "last_step.json").read_text())["step"] == 5
    assert set(restored) == set(trained)
    for k, v in trained.items():  # step 4 started from the trained weights
        torch.testing.assert_close(restored[k], v, rtol=0, atol=0)
    sd = torch.load(os.path.join(ckpt, "last.pt"), weights_only=False)
    assert sd["step"] == 5 and sd["updates"] == 5


def test_pad_batch_time():
    b = pad_batch_time({"image": np.zeros((1, 2, 130), np.float32),
                        "midi": np.zeros((1, 1, 130), np.int64),
                        "beats": np.zeros((1, 1, 130), np.int64), "name": ["x"]}, 128)
    assert b["image"].shape == (1, 2, 256) and (b["image"][..., 130:] == -5.0).all()
    assert (b["midi"][..., 130:] == 128).all() and (b["beats"][..., 130:] == 2).all()
    assert b["name"] == ["x"]


def test_trainer_takes_ema_and_schedule_from_the_model_config(tmp_path):
    sched = dict(target="versband_tpu.train.lr_schedules.LambdaLinearScheduler", params=SHIPPED)
    cfm = CFM(device="cpu", use_ema=True, scheduler_config=sched)
    tr = CFMTrainer(cfm, None, 2.4e-5, logdir=str(tmp_path), use_tensorboard=False)
    want = jls.LambdaLinearScheduler(**SHIPPED)
    assert tr.use_ema
    for s in (0, 5000, 10 ** 6):
        assert tr.tx.lr_at(s) == float(np.float32(2.4e-5) * np.float32(want(s)))
    plain = CFMTrainer(CFM(device="cpu"), None, 2.4e-5, logdir=str(tmp_path),
                       use_tensorboard=False)
    assert not plain.use_ema and plain.tx.lr_at(0) == plain.tx.lr_at(10 ** 6) == 2.4e-5


def test_checkpoint_manager_top_k_archive_and_restore(tmp_path):
    from versband_tpu_torch.train.checkpoints import CheckpointManager
    from versband_tpu_torch.train.state import TrainState, make_adamw

    model = torch.nn.Linear(3, 2)
    state = TrainState(model, make_adamw(1e-3))
    ck = CheckpointManager(str(tmp_path), monitor="val/loss", save_top_k=2,
                           every_n_train_steps=10)
    assert ck.save_step_archive(state, 5) is None and ck.save_step_archive(state, 0) is None
    assert ck.save_step_archive(state, 20).endswith("model_ckpt_steps_20.pt")
    for step, loss in ((1, 0.5), (2, 0.3), (3, 0.9), (4, 0.1)):
        ck.save_monitored(state, step, {"val/loss": loss})
    kept = sorted(p.name for p in tmp_path.glob("epoch_step_*.pt"))
    assert kept == ["epoch_step_2.pt", "epoch_step_4.pt"]  # the two lowest losses
    assert [r["step"] for r in CheckpointManager(str(tmp_path), "val/loss")._scores] == [4, 2]
    assert ck.save_monitored(state, 5, {"other": 0.0}) is None
    assert ck.restore_last(state) is None and ck.last_meta() == {} and ck.last_step() == 0
    w = model.weight.detach().clone()
    ck.save_last(state, 7, extra={"scale_factor": 0.5})
    with torch.no_grad():
        model.weight.zero_()
    assert ck.restore_last(state) is state and ck.last_step() == 7
    torch.testing.assert_close(model.weight.detach(), w, rtol=0, atol=0)
