"""The model axis for the six ConcatDiT variants: JAX's rules
(``versband_tpu/parallel/sharding.py``) pick none of their parameters (the
attention is ``attn1``/``attn2`` with ``to_q/to_k/to_v/to_out``, the
feed-forward a GEGLU convolution), so under ``--n_model`` JAX keeps the whole
model on every rank of a model row, and so does the port.

* Each variant: no JAX leaf is split on a ``(1, 2)`` or ``(1, 4)`` mesh, the
  port's ``param_specs`` pick nothing, and ``shard_module_`` cuts nothing
  (empty slices, no experts owned or absent, every shape whole).
* A parameter the rules pick in a module ``shard_module_`` does not know
  raises, naming it, before anything is cut.
* One spawn of two gloo ranks (``tests/torch_port_tp_worker.py``) runs a
  tiny ``ConcatDiT``'s CFM step at ``(1, 2)``: held to JAX's
  ``shard_train_step`` on the same mesh shape (losses and gradient norm
  within 5e-4 of their scale, the weights within 5e-2 x LR) and to the
  one-process step (1e-5, and 1e-2 x LR), each rank holding the whole
  model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from versband_tpu.models import concat_dit as jcd
from versband_tpu.models.cfm import CFM as JCFM
from versband_tpu.parallel import make_mesh as j_make_mesh
from versband_tpu.parallel.mesh import MODEL_AXIS
from versband_tpu.parallel.sharding import param_shardings
from versband_tpu_torch.models import concat_dit as tcd
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.models.dit import FeedForward
from versband_tpu_torch.parallel.mesh import Mesh
from versband_tpu_torch.parallel.sharding import param_specs, shard_module_
from versband_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import VAE_TINY
from test_torch_port_concat_dit import KW, VARIANTS, _inputs, _tree, perturb_zeros
from test_torch_port_tp_timefreq import EPS, LR, jax_sharded_step, one_process_steps
import torch_port_tp_worker as worker

WORLD = 2
B, T_MEL = 4, 16  # latent 8
CONCAT = dict(in_channels=4, context_dim=12, hidden_size=32, depth=2, num_heads=2, max_len=32)
CFM_KW = dict(unet_config={"target": "versband_tpu.models.concat_dit.ConcatDiT",
                           "params": CONCAT},
              first_stage_config={"target": "versband_tpu.models.autoencoder.AutoencoderKL",
                                  "params": VAE_TINY},
              mel_dim=4, scale_by_std=False, scale_factor=0.7)
JAX_TOL, JAX_PARAM_TOL = 5e-4, 5e-2  # relative; x LR (tests/test_torch_port_tp_step.py)
ONE_TOL, ONE_PARAM_TOL = 1e-5, 1e-2


@pytest.mark.parametrize("name,extra", VARIANTS,
                         ids=[f"{n}-{e.get('cond_fuse', '')}{e.get('unit_upsample_rate', '')}"
                              for n, e in VARIANTS])
def test_the_rules_pick_nothing_and_nothing_is_cut(name, extra):
    x, t, ctx = _inputs(np.random.RandomState(0), name)
    jm = getattr(jcd, name)(**KW, **extra)
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                          jnp.zeros((x.shape[0],)), _tree(ctx, jnp.asarray)))
    for n_model in (2, 4):
        mesh = j_make_mesh(1, n_model, devices=jax.devices()[:n_model])
        specs = [s.spec for s in jax.tree_util.tree_leaves(param_shardings(tree, mesh))]
        assert specs and not any(MODEL_AXIS in tuple(s) for s in specs)
        model = getattr(tcd, name)(**KW, **extra)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert set(param_specs(shapes, n_model).values()) == {None}
        shard_module_(model, Mesh(1, n_model, 0, n_model - 1))
        layout = model.tp_layout
        assert layout.slices == {} and layout.owned == [] and layout.absent == []
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes


def test_a_picked_parameter_in_a_module_not_known_raises():
    """A dense SwiGLU under a ``feed_forward`` name (JAX's rules split its
    w1/w3 by columns and w2 by rows) held by no module kind that
    ``shard_module_`` cuts: the error names the parameter, and nothing was
    cut."""
    model = torch.nn.ModuleDict({"feed_forward": FeedForward(32, 128, 8)})
    with pytest.raises(NotImplementedError, match=r"feed_forward\.w1\.weight \(column\)"):
        shard_module_(model, Mesh(1, 2, 0, 0))
    assert getattr(model, "tp_layout", None) is None
    assert model.feed_forward.w1.weight.shape[1] == 32
    assert model.feed_forward.w1.weight.shape[0] == model.feed_forward.w2.weight.shape[1]


def _case():
    rng = np.random.RandomState(7)
    T = T_MEL // 2
    jm = JCFM(**CFM_KW).model
    params = perturb_zeros(jm.init(jax.random.PRNGKey(3), jnp.zeros((2, 4, T)),
                                   jnp.zeros((2,)), jnp.zeros((2, 5, 12))), 8)
    torch.manual_seed(0)
    cfm = CFM(**CFM_KW, device="cpu")
    cfm.model.load_state_dict(state_dict_from_jax(params, "concat_dit"))
    batch = {"image": torch.from_numpy(rng.randn(B, 80, T_MEL).astype(np.float32)),
             "caption": torch.from_numpy(rng.randn(B, 5, 12).astype(np.float32))}
    given = {"posterior": torch.from_numpy(rng.randn(B, 4, T).astype(np.float32)),
             "t": torch.from_numpy(rng.randint(0, 1000, B)).long(),
             "noise": torch.from_numpy(rng.randn(B, 4, T).astype(np.float32))}
    return cfm, params, batch, given


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_concat")
    cfm, params, batch, given = _case()
    torch.save({"kind": "layouts", "cfm_kwargs": CFM_KW, "dit": cfm.model.state_dict(),
                "vae": cfm.first_stage.state_dict(), "lr": LR, "eps": EPS,
                "layouts": [(1, 2)], "batches": [batch], "givens": [given]},
               root / "inputs.pt")
    ranks = mp.start_processes(worker.main, args=(WORLD, str(root / "rendezvous"),
                                                  str(root / "inputs.pt"), str(root)),
                               nprocs=WORLD, join=False, start_method="spawn")
    ref = {"jax": jax_sharded_step(CFM_KW, "concat_dit", params, cfm.first_stage, batch, given,
                                   (1, 2)),
           "one": one_process_steps(CFM_KW, cfm, [batch], [given])}
    while not ranks.join(timeout=300):
        pass
    ref["ranks"] = [torch.load(root / f"rank{r}.pt", weights_only=False)[(1, 2)]
                    for r in range(WORLD)]
    return ref


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def test_each_rank_holds_the_whole_model(spawned):
    one = spawned["one"]
    assert sorted(r["coords"] for r in spawned["ranks"]) == [(0, 0), (0, 1)]
    for r in spawned["ranks"]:
        assert r["slices"] == [] and r["owned"] == [] and r["absent"] == []
        assert r["local"] == {k: tuple(v.shape) for k, v in one["params"].items()}
        assert r["param_bytes"] == one["param_bytes"]


@pytest.mark.parametrize("ref", ["jax", "one"])
def test_the_step_is_the_one_process_and_jax_step(spawned, ref):
    want = spawned[ref]
    tol, param_tol = (JAX_TOL, JAX_PARAM_TOL) if ref == "jax" else (ONE_TOL, ONE_PARAM_TOL)
    metrics = want["metrics"] if ref == "jax" else want["metrics"][0]
    for r in spawned["ranks"]:
        got = r["metrics"][0]
        for k in ("loss", "loss_simple", "lb_loss", "grad_norm"):
            assert _rel(got[k], metrics[k]) <= tol, (k, got[k], metrics[k])
        assert got["lb_loss"] == 0.0
        assert set(r["params"]) == set(want["params"])
        gap = max(float((r["params"][k] - p).abs().max()) for k, p in want["params"].items())
        assert gap <= param_tol * LR, gap
