"""The model axis for the Time/Freq-MoE DiT (the reference's
``VideoFlagLargeDiT``) over gloo on the CPU: the attention cut over heads,
the frequency experts over the expert index, the time experts whole on
every rank, as JAX's rules leave them.

One spawn of four ranks (``tests/torch_port_tp_worker.py``, a ``file://``
rendezvous under the test's directory) runs three CFM steps of a tiny
Time/Freq DiT (4 heads, 4 + 4 experts, depth 2) at ``(1, 2)`` and at
``(2, 2)``, each data index on its rows of the global batch and of the
injected draws (posterior, t, flow noise); the ``(1, 2)`` run writes its
whole state after the second step and the ``(2, 2)`` ranks resume it for
the third. The weights come from JAX's init (every all-zero leaf drawn off
zero) through ``state_dict_from_jax``.

Held against JAX's ``shard_train_step`` on ``make_mesh`` of the same shape
(the 8-device CPU mesh of ``tests/conftest.py``), first step: losses and
gradient norm within 5e-4 of their scale, the gathered weights within
5e-2 x LR (tests/test_torch_port_tp_step.py's bars); against the port's
one-process steps: 1e-5, and 1e-2 x LR. The time experts' gradients are
the same on every rank of a model row and within 1e-5 of their scale of
the one-process gradients: their output enters the frequency experts
through ``copy_to_model``, whose backward sums the ranks' parts. Then
``cli.train --platform cpu --devices 2 --n_model 2`` trains the shipped
YAML with ``unet_config`` replaced by a tiny ``VideoFlagLargeDiT``, and its
checkpoint resumes in one process.
"""

import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from versband_tpu.models.cfm import CFM as JCFM
from versband_tpu.parallel import make_mesh as j_make_mesh
from versband_tpu.train.state import TrainState as JState, make_adamw as j_adamw
from versband_tpu.train.step import make_cfm_train_step as j_cfm_step
from versband_tpu.train.step import shard_train_step as j_shard_train_step
from versband_tpu_torch.cli import train as cli
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.models.dit_timefreq import TimeFreqMoeDiT
from versband_tpu_torch.train.state import TrainState, make_adamw
from versband_tpu_torch.train.step import make_cfm_train_step
from versband_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import VAE_TINY, Draws, to_jax, write_v2a_manifest
from test_torch_port_concat_dit import perturb_zeros
from test_torch_port_ddp import TINY
import torch_port_tp_worker as worker

WORLD = 4
B, T_MEL, STEPS = 4, 16, 3  # the global batch; latent 8
TIMEFREQ = dict(in_channels=4, context_dim=12, hidden_size=32, depth=2, num_heads=4,
                max_len=32, num_experts=4, multiple_of=8)
TARGET = "versband_tpu.models.dit_timefreq.TimeFreqMoeDiT"
CFM_KW = dict(unet_config={"target": TARGET, "params": TIMEFREQ},
              first_stage_config={"target": "versband_tpu.models.autoencoder.AutoencoderKL",
                                  "params": VAE_TINY},
              mel_dim=4, scale_by_std=False, scale_factor=0.7)
LAYOUTS = [(1, 2), (2, 2)]
LR, EPS = 1e-4, 1e-3  # as tests/test_torch_port_tp_step.py
JAX_TOL, JAX_PARAM_TOL = 5e-4, 5e-2  # relative; x LR
ONE_TOL, ONE_PARAM_TOL = 1e-5, 1e-2


def _case():
    """The weights (JAX's init, zeros drawn off zero; the VAE the port's),
    the batches and their draws."""
    rng = np.random.RandomState(5)
    T = T_MEL // 2
    jm = JCFM(**CFM_KW).model
    params = perturb_zeros(jm.init(jax.random.PRNGKey(4), jnp.zeros((2, 4, T)),
                                   jnp.zeros((2,)), jnp.zeros((2, 5, 12))), 6)
    torch.manual_seed(0)
    cfm = CFM(**CFM_KW, device="cpu")
    cfm.model.load_state_dict(state_dict_from_jax(params, "dit"))
    batches, givens = [], []
    for _ in range(STEPS):
        batches.append({"image": torch.from_numpy(rng.randn(B, 80, T_MEL).astype(np.float32)),
                        "caption": torch.from_numpy(rng.randn(B, 5, 12).astype(np.float32))})
        # t over all four time experts' quarters, so every expert trains
        givens.append({"posterior": torch.from_numpy(rng.randn(B, 4, T).astype(np.float32)),
                       "t": torch.from_numpy(rng.permutation(4) * 250 + rng.randint(0, 250, 4)),
                       "noise": torch.from_numpy(rng.randn(B, 4, T).astype(np.float32))})
    return cfm, params, batches, givens


def one_process_steps(cfm_kw, cfm, batches, givens):
    """The steps in one process from ``cfm``'s weights: the metrics of each,
    the weights after the first and its gradients, the trained parameters'
    bytes."""
    model = CFM(**cfm_kw, device="cpu")
    model.model.load_state_dict(cfm.model.state_dict())
    model.first_stage.load_state_dict(cfm.first_stage.state_dict())
    state = TrainState(model.model, make_adamw(LR, eps=EPS, grad_clip=1.0))
    step = make_cfm_train_step(model)
    seen, apply = [], state.apply_gradients

    def recording():
        seen.append({k: p.grad.clone() for k, p in state.named.items()})
        return apply()

    state.apply_gradients = recording
    out = {"metrics": [], "param_bytes": sum(p.numel() * p.element_size() for p in state.params)}
    for i, (batch, given) in enumerate(zip(batches, givens)):
        out["metrics"].append({k: v.item() for k, v in step(state, batch, given=given).items()})
        if i == 0:
            out["params"] = {k: v.detach().clone() for k, v in model.model.state_dict().items()}
    out["grads"] = seen[0]
    return out


def jax_sharded_step(cfm_kw, family, params, first_stage, batch, given, layout):
    """JAX's ``shard_train_step`` on ``make_mesh(*layout)`` from ``params``,
    its draws replaced by the test's: the metrics and the updated weights
    under the port's names (``family``'s name map)."""
    mp_ = pytest.MonkeyPatch()
    try:
        jcfm = JCFM(**cfm_kw)
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        mp_.setattr(jax.random, "normal", Draws([given["posterior"].numpy(),
                                                 given["noise"].numpy()]))
        mp_.setattr(jax.random, "randint", Draws([given["t"].numpy().astype(np.int32)]))
        mesh = j_make_mesh(*layout, devices=jax.devices()[:layout[0] * layout[1]])
        jstate = JState.create(params, j_adamw(LR, eps=EPS, grad_clip=1.0))
        with mesh:
            step, place_state, place_batch = j_shard_train_step(j_cfm_step(jcfm), jstate,
                                                                jbatch, mesh)
            jstate, metrics = step(place_state(jstate), place_batch(jbatch),
                                   jax.random.PRNGKey(2), to_jax(first_stage, "vae"))
    finally:
        mp_.undo()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": state_dict_from_jax(jax.device_get(jstate.params), family)}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_timefreq")
    cfm, params, batches, givens = _case()
    torch.save({"kind": "layouts", "cfm_kwargs": CFM_KW, "dit": cfm.model.state_dict(),
                "vae": cfm.first_stage.state_dict(), "lr": LR, "eps": EPS,
                "layouts": LAYOUTS, "batches": batches, "givens": givens, "resume": True},
               root / "inputs.pt")
    ranks = mp.start_processes(worker.main, args=(WORLD, str(root / "rendezvous"),
                                                  str(root / "inputs.pt"), str(root)),
                               nprocs=WORLD, join=False, start_method="spawn")
    ref = {"jax": {lay: jax_sharded_step(CFM_KW, "dit", params, cfm.first_stage, batches[0],
                                         givens[0], lay) for lay in LAYOUTS},
           "one": one_process_steps(CFM_KW, cfm, batches, givens)}
    while not ranks.join(timeout=300):
        pass
    ref["ranks"] = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    # the (1, 2) checkpoint, resumed without a group
    model = CFM(**CFM_KW, device="cpu")
    model.model.load_state_dict(cfm.model.state_dict())
    model.first_stage.load_state_dict(cfm.first_stage.state_dict())
    state = TrainState(model.model, make_adamw(LR, eps=EPS, grad_clip=1.0))
    state.load_state_dict(torch.load(root / "ckpt" / "last.pt", weights_only=False))
    ref["resumed_one"] = (state.step, make_cfm_train_step(model)(
        state, batches[2], given=givens[2])["loss"].item())
    return ref


def _members(spawned, layout):
    return [r[layout] for r in spawned["ranks"] if r[layout] is not None]


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: f"data{lay[0]}_model{lay[1]}")
def test_sharded_step_is_jaxs_shard_train_step(spawned, layout):
    members = _members(spawned, layout)
    assert sorted(m["coords"] for m in members) == [
        (d, m) for d in range(layout[0]) for m in range(layout[1])]
    ref = spawned["jax"][layout]
    for m in members:
        got = m["metrics"][0]
        for k in ("loss", "loss_simple", "lb_loss", "grad_norm"):
            assert _rel(got[k], ref["metrics"][k]) <= JAX_TOL, (k, got[k], ref["metrics"][k])
        assert got["lb_loss"] == 0.0  # hard routing: no load-balancing loss
        assert set(m["params"]) == set(ref["params"])
        gap = max(float((m["params"][k] - p).abs().max()) for k, p in ref["params"].items())
        assert gap <= JAX_PARAM_TOL * LR, gap


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: f"data{lay[0]}_model{lay[1]}")
def test_sharded_steps_are_the_one_process_steps(spawned, layout):
    one = spawned["one"]
    for m in _members(spawned, layout):
        for got, want in zip(m["metrics"], one["metrics"]):
            for k, v in want.items():
                assert _rel(got[k], v) <= ONE_TOL, (k, got[k], v)
        for k, p in one["params"].items():
            assert m["params"][k].shape == p.shape, k
            assert float((m["params"][k] - p).abs().max()) <= ONE_PARAM_TOL * LR, k


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: f"data{lay[0]}_model{lay[1]}")
def test_each_rank_holds_its_heads_and_frequency_experts(spawned, layout):
    """2 of 4 heads and 2 of 4 frequency experts per block, this rank's;
    every time expert; the embedders, adaLN and final layer whole."""
    whole = spawned["one"]["params"]
    for m in _members(spawned, layout):
        r, local = m["coords"][1], m["local"]
        for i in range(TIMEFREQ["depth"]):
            pre = f"layers.{i}."
            assert local[pre + "attention.wq.weight"] == (16, 32)
            assert local[pre + "attention.wv_y.weight"] == (16, 32)
            assert local[pre + "attention.wo.weight"] == (32, 16)
            assert local[pre + "attention.gate"] == (4,)  # replicated, sliced at use
            own = {int(k.split(".")[4]) for k in local if k.startswith(pre + "feed_forward.freq")}
            assert own == {2 * r, 2 * r + 1}
            assert {int(k.split(".")[4]) for k in local
                    if k.startswith(pre + "feed_forward.time")} == {0, 1, 2, 3}
        for k in ("t_embedder.mlp.0.weight", "cap_embedder.1.weight", "proj_in.weight",
                  "layers.0.adaLN_modulation.1.weight", "final_layer.linear.weight"):
            assert local[k] == tuple(whole[k].shape), k
        assert all(".attention.w" in k for k in m["slices"])
        assert all(".freq_experts." in k for k in m["owned"] + m["absent"])


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: f"data{lay[0]}_model{lay[1]}")
def test_time_experts_get_whole_gradients_alike_on_every_rank(spawned, layout):
    one = spawned["one"]["grads"]
    members = _members(spawned, layout)
    names = [k for k in members[0]["grads"] if ".time_experts." in k]
    assert len(names) == TIMEFREQ["depth"] * 4 * 3
    for m in members:
        row = [o for o in members if o["coords"][0] == m["coords"][0]]
        for k in names:
            for other in row:
                assert torch.equal(other["grads"][k], m["grads"][k]), k
            scale = float(one[k].abs().max())
            assert scale > 0, k  # every time expert trains: t spans the four quarters
            assert float((m["grads"][k] - one[k]).abs().max()) <= 1e-5 * scale, k


def test_checkpoint_resumes_at_the_other_layout_and_without_a_group(spawned):
    want = spawned["one"]["metrics"][2]["loss"]
    for r in spawned["ranks"]:
        assert r["resumed_step"] == 2
        assert _rel(r["resumed_loss"], want) <= ONE_TOL, (r["resumed_loss"], want)
    step, loss = spawned["resumed_one"]
    assert step == 2 and _rel(loss, want) <= ONE_TOL, (loss, want)


CLI_UNET = ("model.params.unet_config={target: "
            "ldm.modules.diffusionmodules.flag_large_dit_moe.VideoFlagLargeDiT, params: "
            "{in_channels: 4, context_dim: 16, hidden_size: 16, num_heads: 2, depth: 1, "
            "max_len: 64, num_experts: 2, multiple_of: 8}}")


def test_cli_trains_the_time_freq_dit_over_a_model_axis(tmp_path, capfd, monkeypatch):
    manifest, midi = write_v2a_manifest(tmp_path, 316, lengths=(90, 72), seed=0,
                                        vocal_extra=(0, 2))
    logs = tmp_path / "logs"
    over = [f"data.params.main_spec_dir_path={manifest}", f"data.params.other_condition={midi}",
            *TINY, CLI_UNET]
    argv = ["-b", "configs/vocal2music.yaml", "-t", "-n", "tf", "-l", str(logs),
            "--platform", "cpu", "--max_steps", "2", "--no-test"]
    assert cli.main(argv + ["--devices", "2", "--n_model", "2", *over]) == 0
    assert "Training on mesh {'data': 1, 'model': 2}" in capfd.readouterr().out
    (logdir,) = glob.glob(str(logs / "*_tf"))
    ckpt = os.path.join(logdir, "checkpoints")
    assert json.loads(open(os.path.join(ckpt, "last_step.json")).read())["step"] == 2
    saved = torch.load(os.path.join(ckpt, "last.pt"), weights_only=False)
    whole = TimeFreqMoeDiT(in_channels=4, context_dim=16, hidden_size=16, num_heads=2,
                           depth=1, max_len=64, num_experts=2, multiple_of=8).state_dict()
    assert {k: tuple(v.shape) for k, v in saved["model"].items()} == {
        k: tuple(v.shape) for k, v in whole.items()}
    run = {}
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # optional; 12 s to import
    assert cli.main(["-r", logdir, "-t", "--platform", "cpu", "--max_steps", "3",
                     "--no-test"], run=run) == 0
    assert "Resumed at step 2" in capfd.readouterr().out
    assert run["trainer"].global_step == 3 and run["trainer"].world == 1
    assert isinstance(run["trainer"].cfm.model, TimeFreqMoeDiT)
