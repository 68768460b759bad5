"""The port's sharding rules (``versband_tpu_torch/parallel/sharding.py``)
against JAX's (``versband_tpu/parallel/sharding.py``), and the mesh.

* The rules pick the same parameters as JAX's ``PARAM_RULES`` at model 2, 3
  and 4: each JAX leaf of the tiny Band-MoE DiT is filled with its own
  number, carried through the port's name map (``state_dict_from_jax``), and
  a JAX leaf is split exactly when a port parameter holding its number is.
  On the tiny Time/Freq DiT they pick the same too, and the test names
  what: the attention and the frequency experts, not the time experts;
  ``shard_module_`` cuts exactly those.
* The divisibility fallback: at model 3 nothing of width 32 or of 4
  experts divides, so everything is replicated on both sides; and
  ``shard_module_`` keeps an attention whole when its heads do not divide
  (the port's one deviation: JAX would split 48 = 4 x 12 mid-head).
* ``make_mesh`` raises for more ranks than there are, and (one spawn of
  four gloo ranks, ``tests/torch_port_tp_worker.py``) warns for fewer;
  ``shard_module_`` then ``gather_state_dict`` is the identity at (1, 2),
  (2, 2) and (1, 4), each rank holding its heads and experts only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from versband_tpu.models import dit as jdit
from versband_tpu.models import dit_timefreq as jtf
from versband_tpu.parallel import make_mesh as j_make_mesh
from versband_tpu.parallel.mesh import MODEL_AXIS
from versband_tpu.parallel.sharding import param_shardings
from versband_tpu_torch import parallel
from versband_tpu_torch.models import dit_timefreq as ttf
from versband_tpu_torch.models.dit import BandMoeDiT
from versband_tpu_torch.parallel.mesh import Mesh
from versband_tpu_torch.parallel.sharding import (
    COLUMN, EXPERT, HEAD_ROWS, ROW, param_specs, shard_module_)
from versband_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import perturb_zero_init
import torch_port_tp_worker as worker

DIT_TP = dict(in_channels=4, context_dim=32, hidden_size=32, depth=2, num_heads=4,
              max_len=64, num_experts=4, ori_dim=12, multiple_of=8)
TIMEFREQ = dict(in_channels=4, context_dim=12, hidden_size=32, depth=2, num_heads=4,
                max_len=32, num_experts=4, multiple_of=8)
WORLD = 4


def _band_moe_tree(**kw):
    jm = jdit.BandMoeDiT(**kw)
    B, C, T = 2, kw["in_channels"], 8
    ctx = {"c_concat": {"midi": jnp.zeros((B, 1, 2 * T), jnp.int32),
                        "beats": jnp.zeros((B, 1, 2 * T), jnp.int32)},
           "c_crossattn": jnp.zeros((B, 5, kw["ori_dim"]))}
    return jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                           "gumbel": jax.random.PRNGKey(1)},
                                          jnp.zeros((B, C, T)), jnp.zeros((B,)), ctx,
                                          train=True))


def _timefreq_tree():
    jm = jtf.TimeFreqMoeDiT(**TIMEFREQ)
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(1), jnp.zeros((2, 4, 16)),
                                          jnp.zeros((2,)), jnp.zeros((2, 5, 12))))


def _compare(tree, n_model):
    """(JAX's split leaves, the leaves the port's rules split through the
    name map, the port's kinds): each leaf is numbered, filled with its
    number, converted, and read back from the port's tensors."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(l.shape, i + 1, np.float32) for i, l in enumerate(leaves)])
    mesh = j_make_mesh(1, n_model, devices=jax.devices()[:n_model])
    shardings = jax.tree_util.tree_leaves(param_shardings(tagged, mesh))
    jax_split = {i + 1 for i, s in enumerate(shardings) if MODEL_AXIS in tuple(s.spec)}
    sd = state_dict_from_jax(tagged, "dit")
    kinds = param_specs({k: tuple(v.shape) for k, v in sd.items()}, n_model)
    holds = {k: {int(x) for x in np.unique(v.numpy())} for k, v in sd.items()}
    assert set().union(*holds.values()) == set(range(1, len(leaves) + 1))  # every leaf lands
    port_split = set().union(*(holds[k] for k, kind in kinds.items() if kind is not None))
    port_whole = set().union(*(holds[k] for k, kind in kinds.items() if kind is None))
    assert not port_split & port_whole  # no leaf both split and kept whole
    return jax_split, port_split, kinds


@pytest.mark.parametrize("n_model", [2, 3, 4])
def test_rules_pick_what_jax_picks_on_the_band_moe_dit(n_model):
    jax_split, port_split, kinds = _compare(_band_moe_tree(**DIT_TP), n_model)
    assert port_split == jax_split
    picked = {k: v for k, v in kinds.items() if v is not None}
    if n_model == 3:  # nothing of width 32, and not 4 experts, divides by 3
        assert picked == {}
        return
    per_layer = {"attention.wq.weight": COLUMN, "attention.wk.weight": COLUMN,
                 "attention.wv.weight": COLUMN, "attention.wk_y.weight": COLUMN,
                 "attention.wv_y.weight": COLUMN, "attention.wo.weight": ROW,
                 "feed_forward.cross_attention.in_proj_weight": HEAD_ROWS,
                 "feed_forward.cross_attention.out_proj.weight": ROW,
                 **{f"feed_forward.{g}_experts.{e}.w{n}.weight": EXPERT
                    for g in ("caption", "acoustic", "freq") for e in range(4)
                    for n in (1, 2, 3)}}
    assert picked == {f"layers.{i}.{k}": v for i in range(DIT_TP["depth"])
                      for k, v in per_layer.items()}


def test_rules_on_the_time_freq_dit():
    """The same leaves as JAX at model 2: the attention and the frequency
    experts; the time experts (JAX's rules do not name them) stay whole."""
    jax_split, port_split, kinds = _compare(_timefreq_tree(), 2)
    assert port_split == jax_split
    picked = sorted(k for k, v in kinds.items() if v is not None)
    assert any(".freq_experts." in k for k in picked)
    assert not any("time_experts" in k for k in kinds if kinds[k] is not None)
    assert {k.split(".", 2)[2] for k in picked if ".attention." in k} == {
        "attention.wq.weight", "attention.wk.weight", "attention.wv.weight",
        "attention.wk_y.weight", "attention.wv_y.weight", "attention.wo.weight"}
    # shard_module_ cuts what the rules pick, as rank 1 of a (1, 2) mesh
    # holds it (cutting needs no collective): its 2 of 4 heads and its 2 of 4
    # frequency experts per block, every time expert whole
    model = ttf.TimeFreqMoeDiT(**TIMEFREQ)
    shard_module_(model, Mesh(1, 2, 0, 1))
    layout = model.tp_layout
    assert sorted(layout.slices) == [k for k in picked if ".attention." in k]
    assert sorted(layout.owned + layout.absent) == [k for k in picked if "_experts." in k]
    assert {int(k.split(".")[4]) for k in layout.owned} == {2, 3}
    local = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert local["layers.0.attention.wq.weight"] == (16, 32)
    assert local["layers.0.attention.wk_y.weight"] == (16, 32)
    assert local["layers.0.attention.wo.weight"] == (32, 16)
    assert not any(".freq_experts.0." in k or ".freq_experts.1." in k for k in local)
    assert sum(".time_experts." in k for k in local) == 2 * 4 * 3


def test_an_attention_whose_heads_do_not_divide_stays_whole():
    """At model 3 over 4 heads of 12 (48 wide) JAX splits the attention's
    columns mid-head; the port keeps that attention, and the 8-head caption
    attention, whole. Cutting needs no collective, so a mesh without a
    group shows what one rank would hold."""
    kw = {**DIT_TP, "hidden_size": 48, "context_dim": 48, "num_experts": 3}
    jax_split, port_split, kinds = _compare(_band_moe_tree(**kw), 3)
    assert port_split == jax_split
    assert kinds["layers.0.attention.wq.weight"] == COLUMN  # the dimension divides
    model = BandMoeDiT(**kw)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    shard_module_(model, Mesh(1, 3, 0, 0))
    layout = model.tp_layout
    assert not any("attention" in k for k in layout.slices)
    assert layout.absent and all("_experts." in k for k in layout.absent + layout.owned)
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: s for k, s in shapes.items() if k not in layout.absent}


def test_make_mesh_needs_enough_ranks():
    assert parallel.make_mesh(1, 1).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match=r"needs 2 ranks but only 1"):
        parallel.make_mesh(1, 2)
    with pytest.raises(ValueError, match="not divisible by n_model=2"):
        parallel.make_mesh(None, 2)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_rules")
    torch.manual_seed(0)
    model = BandMoeDiT(**DIT_TP)
    perturb_zero_init(model, 0)
    rng = np.random.RandomState(2)
    B, T = 2, 8
    context = {"c_concat": {"midi": torch.from_numpy(rng.randint(0, 130, (B, 1, 2 * T))),
                            "beats": torch.from_numpy(rng.randint(0, 3, (B, 1, 2 * T)))},
               "c_crossattn": torch.from_numpy(rng.randn(B, 5, 12).astype(np.float32))}
    eval_inputs = (torch.from_numpy(rng.randn(B, 4, T).astype(np.float32)),
                   torch.tensor([3.0, 700.0]), context)
    torch.save({"kind": "rules", "dit_kwargs": DIT_TP, "dit": model.state_dict(),
                "eval_inputs": eval_inputs}, root / "inputs.pt")
    mp.start_processes(worker.main, args=(WORLD, str(root / "rendezvous"),
                                          str(root / "inputs.pt"), str(root)),
                       nprocs=WORLD, join=True, start_method="spawn")
    return model.state_dict(), [torch.load(root / f"rank{r}.pt", weights_only=False)
                                for r in range(WORLD)]


def test_a_mesh_smaller_than_the_group_warns(spawned):
    for r in spawned[1]:
        assert r["warnings"] == ["mesh (1 x 2) uses only 2 of 4 ranks"]


@pytest.mark.parametrize("layout", [(1, 2), (2, 2), (1, 4)],
                         ids=lambda lay: f"data{lay[0]}_model{lay[1]}")
def test_shard_then_gather_is_the_identity(spawned, layout):
    whole, ranks = spawned
    m = layout[1]
    assert [r[layout] is None for r in ranks] == [i >= layout[0] * m for i in range(WORLD)]
    for rank, r in enumerate(ranks[:layout[0] * m]):
        got = r[layout]
        assert list(got["gathered"]) == list(whole)
        for k, v in whole.items():
            assert torch.equal(got["gathered"][k], v), k
        local = got["local"]
        mr = rank % m
        # this rank's experts only, under their one-process names
        own = {int(k.split(".")[4]) for k in local if ".caption_experts." in k}
        assert own == set(range(mr * 4 // m, (mr + 1) * 4 // m))
        assert local["layers.0.attention.wq.weight"] == (32 // m, 32)
        assert local["layers.0.attention.wo.weight"] == (32, 32 // m)
        assert local["layers.0.feed_forward.cross_attention.in_proj_weight"] == (96 // m, 32)
        assert local["layers.0.attention.gate"] == (4,)  # replicated, sliced at use


@pytest.mark.parametrize("routed", [False, True], ids=["dense", "routed"])
def test_cut_model_serves_as_the_whole_one(spawned, routed):
    """Eval routing (hard, no noise) through the cut model, each token's
    expert on one rank of the model group (the routed path: its tokens only,
    zeros for the others' before the sum): the whole model's output within
    1e-5 of scale."""
    _, ranks = spawned
    for layout in [(1, 2), (2, 2), (1, 4)]:
        for r in ranks[:layout[0] * layout[1]]:
            whole, cut = r[layout]["eval"][routed]
            assert float((cut - whole).abs().max()) <= 1e-5 * float(whole.abs().max()), layout
