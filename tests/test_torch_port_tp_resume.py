"""A checkpoint written under a ``(data, model)`` mesh is whole and resumes
at any layout (the port's counterpart of
``tests/test_mesh_reshape_resume.py``), over gloo on the CPU.

One spawn of two ranks (``tests/torch_port_tp_worker.py``) trains three CFM
steps of a tiny Band-MoE DiT at (1, 2), EMA on, the draws injected, and
rank 0 writes the whole state after the second; the same ranks then resume
it at (2, 1) and take the third step again. Here, without a group, the same
checkpoint resumes in one process. Each third loss equals the uninterrupted
run's within 1e-5 (reduction orders differ by layout), and the checkpoint's
keys and shapes (weights, Adam moments, EMA) are the one-process
checkpoint's. Then ``cli.train --platform cpu --devices 2 --n_model 2``
trains 2 steps over its own two ranks, and its checkpoint resumes in one
process.
"""

import copy
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from versband_tpu_torch.cli import train as cli
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.train.state import TrainState, make_adamw
from versband_tpu_torch.train.step import make_cfm_train_step
from torch_port_helpers import BEATS_V, MIDI_V, VAE_TINY, perturb_zero_init, write_v2a_manifest
from test_torch_port_ddp import TINY
import torch_port_tp_worker as worker

WORLD = 2
B, T_MEL, STEPS = 4, 16, 3
DIT_TP = dict(in_channels=4, context_dim=32, hidden_size=32, depth=2, num_heads=4,
              max_len=64, num_experts=4, ori_dim=12, multiple_of=8, use_flash=True)
CFM_KW = dict(unet_config={"target": "versband_tpu.models.dit.BandMoeDiT", "params": DIT_TP},
              first_stage_config={"target": "versband_tpu.models.autoencoder.AutoencoderKL",
                                  "params": VAE_TINY},
              mel_dim=4, scale_by_std=False, scale_factor=0.7)
LR, EPS, EMA = 1e-4, 1e-3, 0.999
LOSS_TOL = 1e-5


def _case():
    torch.manual_seed(0)
    cfm = CFM(**CFM_KW, device="cpu")
    perturb_zero_init(cfm.model, 0)
    rng = np.random.RandomState(3)
    T = T_MEL // 2
    batches, givens = [], []
    for _ in range(STEPS):
        batches.append({
            "image": torch.from_numpy(rng.randn(B, 80, T_MEL).astype(np.float32)),
            "caption": torch.from_numpy(rng.randn(B, 5, 12).astype(np.float32)),
            "midi": torch.from_numpy(rng.randint(0, MIDI_V, (B, 1, T_MEL)).astype(np.int32)),
            "beats": torch.from_numpy(rng.randint(0, BEATS_V, (B, 1, T_MEL)).astype(np.int32))})
        givens.append({
            "posterior": torch.from_numpy(rng.randn(B, 4, T).astype(np.float32)),
            "t": torch.from_numpy(rng.randint(0, 1000, B)).long(),
            "noise": torch.from_numpy(rng.randn(B, 4, T).astype(np.float32)),
            "gumbel": [torch.from_numpy(rng.gumbel(size=s).astype(np.float32))
                       for s in cfm.model.gumbel_shapes(B, T)]})
    return cfm, batches, givens


def _one_process(cfm):
    model = CFM(**CFM_KW, device="cpu")
    model.model.load_state_dict(cfm.model.state_dict())
    model.first_stage.load_state_dict(cfm.first_stage.state_dict())
    state = TrainState(model.model, make_adamw(LR, eps=EPS, grad_clip=1.0), ema_decay=EMA)
    return make_cfm_train_step(model), state


def _step(step, state, batch, given):
    given = dict(given)
    given["gumbel"] = iter(given["gumbel"])
    return step(state, batch, given=given)["loss"].item()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_resume")
    cfm, batches, givens = _case()
    torch.save({"kind": "layouts", "layouts": [(1, 2), (2, 1)], "resume": True,
                "cfm_kwargs": CFM_KW, "dit": cfm.model.state_dict(),
                "vae": cfm.first_stage.state_dict(), "lr": LR, "eps": EPS, "ema": EMA,
                "batches": batches, "givens": givens}, root / "inputs.pt")
    ranks = mp.start_processes(worker.main, args=(WORLD, str(root / "rendezvous"),
                                                  str(root / "inputs.pt"), str(root)),
                               nprocs=WORLD, join=False, start_method="spawn")
    step, state = _one_process(cfm)
    losses, ckpt2 = [], None
    for i in range(STEPS):
        losses.append(_step(step, state, batches[i], givens[i]))
        if i == 1:
            ckpt2 = copy.deepcopy(state.state_dict())  # its tensors are the live ones
    while not ranks.join(timeout=300):
        pass
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    saved = torch.load(root / "ckpt" / "last.pt", weights_only=False)
    step, state = _one_process(cfm)
    state.load_state_dict(saved)
    resumed = _step(step, state, batches[2], givens[2])
    return {"losses": losses, "one_ckpt": ckpt2, "saved": saved, "ranks": ranks,
            "resumed_one": resumed}


def test_the_mesh_run_is_the_uninterrupted_run(run):
    for r in run["ranks"]:
        np.testing.assert_allclose([m["loss"] for m in r[(1, 2)]["metrics"]], run["losses"],
                                   rtol=LOSS_TOL)


def test_resumes_at_another_layout_and_without_a_group(run):
    want = run["losses"][2]
    for r in run["ranks"]:
        assert r["resumed_step"] == 2
        assert abs(r["resumed_loss"] - want) <= LOSS_TOL * abs(want)
    assert abs(run["resumed_one"] - want) <= LOSS_TOL * abs(want)


def test_the_checkpoint_is_the_one_process_checkpoint(run):
    saved, one = run["saved"], run["one_ckpt"]
    assert set(saved) == set(one)
    assert (saved["step"], saved["updates"], saved["mini_step"]) == (2, 2, 0)
    assert list(saved["model"]) == list(one["model"])
    for k, v in one["model"].items():
        assert saved["model"][k].shape == v.shape, k
    so, oo = saved["optimizer"], one["optimizer"]
    assert sorted(so["state"]) == sorted(oo["state"])
    assert so["param_groups"][0]["params"] == oo["param_groups"][0]["params"]
    for j, st in oo["state"].items():
        assert set(so["state"][j]) == set(st)
        for key, v in st.items():
            assert so["state"][j][key].shape == v.shape, (j, key)
    assert set(saved["ema"]["shadow"]) == set(one["ema"]["shadow"])
    assert saved["ema"]["num_updates"] == one["ema"]["num_updates"] == 2
    for k, v in one["ema"]["shadow"].items():
        assert saved["ema"]["shadow"][k].shape == v.shape, k
        # the EMA of the same two updates, whatever the layout
        assert float((saved["ema"]["shadow"][k] - v).abs().max()) <= 1e-2 * LR, k


def test_cli_trains_with_a_model_axis_and_resumes_on_one(tmp_path, capfd, monkeypatch):
    manifest, midi = write_v2a_manifest(tmp_path, 316, lengths=(90, 72), seed=0,
                                        vocal_extra=(0, 2))
    logs = tmp_path / "logs"
    over = [f"data.params.main_spec_dir_path={manifest}", f"data.params.other_condition={midi}",
            *TINY]
    argv = ["-b", "configs/vocal2music.yaml", "-t", "-n", "tp", "-l", str(logs),
            "--platform", "cpu", "--max_steps", "2", "--no-test"]
    assert cli.main(argv + ["--devices", "2", "--n_model", "2", *over]) == 0
    out = capfd.readouterr().out
    assert "Training on mesh {'data': 1, 'model': 2}" in out
    # one model row loads one batch: the LR's devices factor is the data axis
    assert "Setting learning rate to 1.20e-05 = 1 (accumulate) * 1 (devices) * 4 (bs)" in out
    (logdir,) = glob.glob(str(logs / "*_tp"))
    ckpt = os.path.join(logdir, "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["last.pt", "last_step.json"]
    assert json.loads(open(os.path.join(ckpt, "last_step.json")).read())["step"] == 2
    run = {}
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # optional; 12 s to import
    assert cli.main(["-r", logdir, "-t", "--platform", "cpu", "--max_steps", "3",
                     "--no-test"], run=run) == 0
    assert "Resumed at step 2" in capfd.readouterr().out
    assert run["trainer"].global_step == 3 and run["trainer"].world == 1
