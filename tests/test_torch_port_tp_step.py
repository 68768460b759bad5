"""Tensor and expert parallelism in the port (``parallel.mesh``,
``parallel.sharding``, ``train.step.shard_train_step``) over gloo on the
CPU: one spawn of four ranks (``tests/torch_port_tp_worker.py``, a
``file://`` rendezvous under the test's directory) runs the CFM step of a
tiny Band-MoE DiT (4 heads, 4 experts per group, so that both divide by 4)
at the ``(data, model)`` layouts ``(1, 2)``, ``(2, 2)`` and ``(1, 4)``, each
data index on its rows of one global batch with its rows of the injected
draws (posterior, t, flow noise, Gumbel).

Each layout is held against JAX's ``shard_train_step`` on ``make_mesh`` of
the same shape (the existing 8-device CPU mesh of ``tests/conftest.py``):
losses and gradient norm within 5e-4 of their scale (the DiT bar), the
gathered updated parameters within 5e-2 x LR (one AdamW step moves an
element by about LR; as tests/test_torch_port_ddp.py); and against the
port's one-process step on the whole batch: 1e-5, and 1e-2 x LR.

Three variants at ``(2, 2)`` show what the data axis must get right: the
load-balancing usage of one rank's rows alone misses the bar; the
gradients averaged over every rank (mixing different shards) miss it by
far; the usage summed over every rank meets it, because each model row is
counted ``n_model`` times in the numerator and the denominator alike.
"""

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
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.train.state import TrainState, make_adamw
from versband_tpu_torch.train.step import make_cfm_train_step
from versband_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import BEATS_V, MIDI_V, VAE_TINY, Draws, perturb_zero_init, to_jax
import torch_port_tp_worker as worker

WORLD = 4
B = 4  # the global batch
T_MEL = 16
DIT_TP = dict(in_channels=4, context_dim=32, hidden_size=32, depth=2, num_heads=4,
              max_len=64, num_experts=4, ori_dim=12, multiple_of=8)


def cfm_kwargs(use_flash: bool) -> dict:
    return dict(unet_config={"target": "versband_tpu.models.dit.BandMoeDiT",
                             "params": {**DIT_TP, "use_flash": use_flash}},
                first_stage_config={"target": "versband_tpu.models.autoencoder.AutoencoderKL",
                                    "params": VAE_TINY},
                mel_dim=4, scale_by_std=False, scale_factor=0.7)


LR, EPS = 1e-4, 1e-3  # as tests/test_torch_port_train_step.py
DIT_TOL = 5e-4
PARAM_TOL = 5e-2  # x LR, on the gathered updated parameters
LAYOUTS = [(1, 2), (2, 2), (1, 4)]


def _case():
    torch.manual_seed(0)
    cfm = CFM(**cfm_kwargs(True), device="cpu")
    perturb_zero_init(cfm.model, 0)
    rng = np.random.RandomState(1)
    T = T_MEL // 2
    batch = {"image": rng.randn(B, 80, T_MEL).astype(np.float32),
             "caption": rng.randn(B, 5, 12).astype(np.float32),
             "midi": rng.randint(0, MIDI_V, (B, 1, T_MEL)).astype(np.int32),
             "beats": rng.randint(0, BEATS_V, (B, 1, T_MEL)).astype(np.int32)}
    draws = {"posterior": rng.randn(B, 4, T).astype(np.float32),
             "t": rng.randint(0, 1000, B).astype(np.int32),
             "noise": rng.randn(B, 4, T).astype(np.float32),
             "gumbel": [rng.gumbel(size=s).astype(np.float32)
                        for s in cfm.model.gumbel_shapes(B, T)]}
    return cfm, batch, draws


def _given(draws):
    return {"posterior": torch.from_numpy(draws["posterior"]),
            "t": torch.from_numpy(draws["t"]).long(),
            "noise": torch.from_numpy(draws["noise"]),
            "gumbel": [torch.from_numpy(g) for g in draws["gumbel"]]}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """What each of the four ranks saw, JAX's sharded steps and the port's
    one-process step (computed while the ranks run)."""
    root = tmp_path_factory.mktemp("tp_step")
    cfm, batch, draws = _case()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    torch.save({"kind": "step", "cfm_kwargs": cfm_kwargs(True), "dit": cfm.model.state_dict(),
                "vae": cfm.first_stage.state_dict(), "lr": LR, "eps": EPS, "batch": tbatch,
                "given": _given(draws)}, root / "inputs.pt")
    ranks = mp.start_processes(worker.main, args=(WORLD, str(root / "rendezvous"),
                                                  str(root / "inputs.pt"), str(root)),
                               nprocs=WORLD, join=False, start_method="spawn")
    ref = {"jax": {lay: _jax_sharded(cfm, batch, draws, lay) for lay in LAYOUTS},
           "one": _one_process(cfm, tbatch, draws)}
    while not ranks.join(timeout=300):
        pass
    ref["ranks"] = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ref


def _jax_sharded(cfm, batch, draws, layout):
    """JAX's ``shard_train_step`` on ``make_mesh(*layout)``, its draws
    replaced by the test's (plain attention on the JAX side: the same
    function as the flash path, without compiling the interpreted kernel)."""
    mp_ = pytest.MonkeyPatch()
    try:
        params, vae_params = to_jax(cfm.model, "dit"), to_jax(cfm.first_stage, "vae")
        jcfm = JCFM(**cfm_kwargs(False))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        mp_.setattr(jax.random, "normal", Draws([draws["posterior"], draws["noise"]]))
        mp_.setattr(jax.random, "randint", Draws([draws["t"]]))
        mp_.setattr(jax.random, "gumbel", Draws(draws["gumbel"]))
        mesh = j_make_mesh(*layout, devices=jax.devices()[:layout[0] * layout[1]])
        jstate = JState.create(params, j_adamw(LR, eps=EPS, grad_clip=1.0))
        with mesh:
            step, place_state, place_batch = j_shard_train_step(j_cfm_step(jcfm), jstate,
                                                                jbatch, mesh)
            jstate, metrics = step(place_state(jstate), place_batch(jbatch),
                                   jax.random.PRNGKey(2), vae_params)
    finally:
        mp_.undo()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": state_dict_from_jax(jax.device_get(jstate.params), "dit")}


def _one_process(cfm, tbatch, draws):
    model = CFM(**cfm_kwargs(True), device="cpu")
    model.model.load_state_dict(cfm.model.state_dict())
    model.first_stage.load_state_dict(cfm.first_stage.state_dict())
    state = TrainState(model.model, make_adamw(LR, eps=EPS, grad_clip=1.0))
    given = _given(draws)
    given["gumbel"] = iter(given["gumbel"])
    metrics = make_cfm_train_step(model)(state, tbatch, given=given)
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "params": {k: v.detach().clone() for k, v in model.model.state_dict().items()}}


def _gaps(got, ref):
    """Losses and gradient norm against their size (at least 1), the
    updated parameters in units of LR."""
    gaps = {k: abs(got["metrics"][k] - ref["metrics"][k]) / max(1.0, abs(ref["metrics"][k]))
            for k in ("loss", "loss_simple", "lb_loss", "grad_norm")}
    gaps["params"] = max(float((got["params"][k] - p).abs().max())
                         for k, p in ref["params"].items()) / LR
    return gaps


def _members(spawned, key):
    return [r[key] for r in spawned["ranks"] if r[key] is not None]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: f"data{lay[0]}_model{lay[1]}")
def test_sharded_step_is_jaxs_shard_train_step(spawned, layout):
    """Every rank of the mesh ends with the same metrics and gathered
    weights, and they are JAX's sharded step's on the same mesh shape."""
    members = _members(spawned, layout)
    assert len(members) == layout[0] * layout[1]
    assert sorted(m["coords"] for m in members) == [
        (d, m) for d in range(layout[0]) for m in range(layout[1])]
    for other in members[1:]:
        assert other["metrics"] == members[0]["metrics"]
        for k, p in members[0]["params"].items():
            assert torch.equal(other["params"][k], p), k
    gaps = _gaps(members[0], spawned["jax"][layout])
    assert gaps["params"] <= PARAM_TOL, gaps
    assert max(v for k, v in gaps.items() if k != "params") <= DIT_TOL, gaps


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: f"data{lay[0]}_model{lay[1]}")
def test_sharded_step_is_the_one_process_step(spawned, layout):
    got, ref = _members(spawned, layout)[0], spawned["one"]
    for k, v in ref["metrics"].items():
        assert abs(got["metrics"][k] - v) <= 1e-5 * max(1.0, abs(v)), k
    assert set(got["params"]) == set(ref["params"])
    for k, p in ref["params"].items():
        assert got["params"][k].shape == p.shape, k
        assert float((got["params"][k] - p).abs().max()) <= 1e-2 * LR, k


def test_each_rank_holds_its_part(spawned):
    """At model 2 each rank holds fewer weights than the whole; at model 4
    fewer still; each step runs the same number of model-axis all-reduces
    (4 forward and 11 backward per block), of fewer bytes when the data axis
    halves the rows (all but the replicated biases' and gates' gradients)."""
    whole = sum(p.numel() for p in spawned["one"]["params"].values())
    sizes = {lay: _members(spawned, lay)[0]["local_numel"] for lay in LAYOUTS}
    assert sizes[(1, 4)] < sizes[(1, 2)] == sizes[(2, 2)] < whole
    reduces = {lay: _members(spawned, lay)[0]["reduces"] for lay in LAYOUTS}
    assert {n for n, _ in reduces.values()} == {15 * DIT_TP["depth"]}
    assert reduces[(2, 2)][1] < reduces[(1, 2)][1] == reduces[(1, 4)][1]


@pytest.mark.parametrize("variant", ["per_rank_usage", "world_grads", "world_usage"])
def test_what_the_data_axis_must_get_right(spawned, variant):
    """At (2, 2): the usage of one rank's rows alone and gradients averaged
    over every rank miss JAX's bar; the usage summed over every rank meets
    it (each model row counted twice above and below the fraction)."""
    got = _members(spawned, variant)[0]
    gaps = _gaps(got, spawned["jax"][(2, 2)])
    misses = max(v for k, v in gaps.items() if k != "params") > DIT_TOL \
        or gaps["params"] > PARAM_TOL
    if variant == "world_usage":
        assert not misses, gaps
    else:
        assert misses, gaps
    if variant == "world_grads":
        assert gaps["params"] > 1.0, gaps  # the shards' gradients mixed: LR-sized moves
