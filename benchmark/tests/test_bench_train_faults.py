"""The training driver at tiny widths on the CPU: the reference follows the
program's checked steps, and with the timed path broken underneath the run
comes out not correct. The harness's look for a card is skipped."""

import os
import time

import pytest
import torch

from benchmark.drivers import train
from benchmark.lib import compare
from benchmark.tests.tiny import tiny_train_cell, tiny_vae_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 91


@pytest.fixture(autouse=True)
def _tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))


def _judge(cell):
    out = train.run(cell, SEED, 1.0, False, time.perf_counter(), CPU)
    ok, _ = compare.judge(out["checks"], cell["limits"])
    return ok, out["checks"]


def _state_unchanged(monkeypatch):
    """Every step leaves the parameters as they were."""
    from versband_tpu_torch.train.state import TrainState

    def unchanged(self):
        self.step += 1
        self.updates += 1
        self.optimizer.zero_grad(set_to_none=True)
        return True

    monkeypatch.setattr(TrainState, "apply_gradients", unchanged)


def _half_batch_left_out(monkeypatch):
    """The loss taken over the first half of the batch only."""
    from versband_tpu_torch.models import cfm

    losses = cfm.cfm_p_losses

    def half(model, x_start, cond, t, noise, **kw):
        n = x_start.shape[0] // 2
        cut = {"caption": cond["caption"][:n],
               "acoustic": {k: v[:n] for k, v in cond["acoustic"].items()}}
        return losses(model, x_start[:n], cut, t[:n], noise[:n], **kw)

    monkeypatch.setattr(cfm, "cfm_p_losses", half)


def _answer_altered(monkeypatch):
    """The flow field the DiT produces in training scaled by 1.01."""
    from versband_tpu_torch.models.dit import BandMoeDiT

    forward = BandMoeDiT.forward

    def altered(self, *args, **kw):
        out = forward(self, *args, **kw)
        return (out[0] * 1.01, out[1]) if kw.get("train") else out

    monkeypatch.setattr(BandMoeDiT, "forward", altered)


def test_reference_follows_the_program():
    out = train.run(tiny_train_cell(), SEED, 1.0, False, time.perf_counter(), CPU)
    checks = out["checks"]
    assert checks["loss_gap"] < 1e-6 and checks["grad_gap"] < 1e-5 \
        and checks["update_gap"] < 1e-5, checks
    assert checks["loader_mismatch"] == 0 and checks["failed_steps"] == 0
    assert out["attempted"] > 0
    assert os.listdir(os.path.join(os.environ["TMPDIR"], "versband_bench")) == []


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch_left_out, _answer_altered])
def test_a_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    ok, checks = _judge(tiny_train_cell())
    assert not ok, checks


def _vae_half_batch_left_out(monkeypatch):
    """Stage 1's reconstruction and KL terms over the first half of the batch."""
    from versband_tpu_torch.train.gan_losses import VAEGANLoss

    nll_kl = VAEGANLoss.nll_kl

    class _Half:
        def __init__(self, post, n):
            self.post, self.n = post, n

        def kl(self):
            return self.post.kl()[: self.n]

    def half(self, inputs, recon, posterior, weights=None):
        n = inputs.shape[0] // 2
        return nll_kl(self, inputs[:n], recon[:n], _Half(posterior, n), weights)

    monkeypatch.setattr(VAEGANLoss, "nll_kl", half)


def _vae_answer_altered(monkeypatch):
    """The VAE's reconstruction scaled by 1.01 where it is produced."""
    from versband_tpu_torch.models.autoencoder import AutoencoderKL

    decode = AutoencoderKL.decode
    monkeypatch.setattr(AutoencoderKL, "decode", lambda self, z: decode(self, z) * 1.01)


def test_stage1_reference_follows_the_program():
    out = train.run(tiny_vae_cell(), SEED, 1.0, False, time.perf_counter(), CPU)
    checks = out["checks"]
    assert checks["loss_gap"] < 1e-6 and checks["grad_gap"] < 1e-5 \
        and checks["update_gap"] < 1e-2, checks
    assert checks["loader_mismatch"] == 0 and checks["failed_steps"] == 0


@pytest.mark.parametrize("fault", [_state_unchanged, _vae_half_batch_left_out,
                                   _vae_answer_altered])
def test_a_stage1_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    ok, checks = _judge(tiny_vae_cell())
    assert not ok, checks
