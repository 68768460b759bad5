"""The port's CFM train step, optimizer and EMA against ``versband_tpu.train``
(fp32, CPU).

* One ``make_cfm_train_step`` step from the same weights, batch and draws
  (the VAE posterior's normal draw, t, the flow noise, the Gumbel noise),
  fed to the JAX step by replacing ``jax.random.normal``/``randint``/
  ``gumbel`` in the test only: loss, gradients and updated parameters.
* Gradient accumulation (``optax.MultiSteps`` semantics) and the EMA tick
  per optimizer step, on the cases of tests/test_grad_accum.py, run on
  both sides with the same gradients.
* ``state_dict_from_jax`` maps a gradient tree (the params' structure).

Tolerances: loss 1e-5; gradients 1e-4 of the largest gradient (fp32 through
two blocks, summation order); updated parameters 1e-8 absolute plus 3e-7
relative (two float32 ulps of the weight), at an LR of 1e-4 with AdamW's eps
at 1e-3 on both sides. AdamW's first step moves a
weight by lr * g / (|g| + eps), which turns a gradient difference dg into
lr * eps / (|g| + eps)^2 * dg: at the default eps of 1e-8 a gradient of
~1e-8 amplifies fp32 summation noise ~1e4-fold, at 1e-3 at most 0.1-fold.
The optimizer cases run at the default eps, tolerance 1e-6 absolute, or
1e-5 relative where an update of 0.1 shows: optax rounds the betas to float32
(1 - 0.999 becomes 9.99987e-4) where torch keeps the bias corrections in
float64, so the first AdamW update differs by 6.5e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models.cfm import CFM as JCFM
from versband_tpu.train.state import TrainState as JState, make_adamw as j_adamw
from versband_tpu.train.step import make_cfm_train_step as j_step
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.train.state import TrainState, ema_scope, make_adamw
from versband_tpu_torch.train.step import _decompress_batch, make_cfm_train_step
from versband_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import (
    BEATS_V, DIT_TINY, MIDI_V, VAE_TINY, Draws, assert_grads_match, perturb_zero_init, to_jax)

DIT = {**DIT_TINY, "use_flash": True}
UNET = {"target": "versband_tpu.models.dit.BandMoeDiT", "params": DIT}
VAE = {"target": "versband_tpu.models.autoencoder.AutoencoderKL", "params": VAE_TINY}
LR = 1e-4
EPS = 1e-3


def _port_cfm():
    torch.manual_seed(0)
    cfm = CFM(unet_config=UNET, first_stage_config=VAE, mel_dim=4, scale_by_std=False,
              scale_factor=0.7, device="cpu")
    perturb_zero_init(cfm.model, 0)
    return cfm


def _batch_and_draws(cfm, B=2, t_mel=16, seed=1):
    rng = np.random.RandomState(seed)
    batch = {"image": rng.randn(B, 80, t_mel).astype(np.float32),
             "caption": rng.randn(B, 5, 12).astype(np.float32),
             "midi": rng.randint(0, MIDI_V, (B, 1, t_mel)).astype(np.int32),
             "beats": rng.randint(0, BEATS_V, (B, 1, t_mel)).astype(np.int32)}
    T = t_mel // 2
    draws = {"posterior": rng.randn(B, 4, T).astype(np.float32),
             "t": np.array([17, 912], np.int32),
             "noise": rng.randn(B, 4, T).astype(np.float32),
             "gumbel": [rng.gumbel(size=s).astype(np.float32)
                        for s in cfm.model.gumbel_shapes(B, T)]}
    return batch, draws


def _given(draws):
    return {"posterior": torch.from_numpy(draws["posterior"]),
            "t": torch.from_numpy(draws["t"]).long(),
            "noise": torch.from_numpy(draws["noise"]),
            "gumbel": iter(torch.from_numpy(g) for g in draws["gumbel"])}


def _patch_jax(monkeypatch, draws):
    monkeypatch.setattr(jax.random, "normal", Draws([draws["posterior"], draws["noise"]]))
    monkeypatch.setattr(jax.random, "randint", Draws([draws["t"]]))
    monkeypatch.setattr(jax.random, "gumbel", Draws(draws["gumbel"]))


def test_train_step_matches_jax(monkeypatch):
    cfm = _port_cfm()
    params = to_jax(cfm.model, "dit")
    vae_params = to_jax(cfm.first_stage, "vae")
    batch, draws = _batch_and_draws(cfm)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jcfm = JCFM(unet_config=UNET, first_stage_config=VAE, mel_dim=4, scale_by_std=False,
                scale_factor=0.7)

    # the JAX step: loss, gradients (of the same loss function) and new params
    _patch_jax(monkeypatch, draws)
    x_start = jcfm.encode_first_stage(vae_params, jnp.asarray(batch["image"]),
                                      jax.random.PRNGKey(0))
    cond = {"caption": jnp.asarray(batch["caption"]),
            "acoustic": {"midi": jnp.asarray(batch["midi"]), "beats": jnp.asarray(batch["beats"])}}
    monkeypatch.setattr(jax.random, "normal", Draws([draws["noise"]]))
    monkeypatch.setattr(jax.random, "gumbel", Draws(draws["gumbel"]))
    (_, ref_parts), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jcfm.p_losses(p, x_start, cond, jnp.asarray(draws["t"]),
                                jax.random.PRNGKey(1)), has_aux=True))(params)
    _patch_jax(monkeypatch, draws)
    jstate = JState.create(params, j_adamw(LR, eps=EPS, grad_clip=1.0))
    jstate, jmetrics = jax.jit(j_step(jcfm, vae_params))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(2))

    # the port: gradients of the loss, then one step
    given = _given(draws)
    x = cfm.encode_first_stage(tbatch["image"], noise=given["posterior"])
    tcond = {"caption": tbatch["caption"],
             "acoustic": {"midi": tbatch["midi"], "beats": tbatch["beats"]}}
    loss, _ = cfm.p_losses(x, tcond, given["t"], noise=given["noise"], gumbel=given["gumbel"])
    loss.backward()
    assert_grads_match(cfm.model, ref_grads)
    state = TrainState(cfm.model, make_adamw(LR, eps=EPS, grad_clip=1.0))
    metrics = make_cfm_train_step(cfm)(state, tbatch, given=_given(draws))

    assert set(metrics) == {"loss", "loss_simple", "lb_loss", "grad_norm"}
    for k in ("loss", "loss_simple", "lb_loss"):
        assert abs(metrics[k].item() - float(jmetrics[k])) <= 1e-5, k
        assert abs(metrics[k].item() - float(ref_parts[k])) <= 1e-5, k
    assert abs(metrics["grad_norm"].item() - float(jmetrics["grad_norm"])) \
        <= 1e-4 * float(jmetrics["grad_norm"])
    assert state.step == 1 and int(jstate.step) == 1
    ref_params = state_dict_from_jax(jax.device_get(jstate.params), "dit")
    before = state_dict_from_jax(params, "dit")
    moved = 0.0
    for k, p in cfm.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref_params[k].numpy(), atol=1e-8, rtol=3e-7,
                                   err_msg=k)
        moved = max(moved, (p - before[k]).abs().max().item())
    assert moved > 0.5 * LR


def test_decompress_batch_widens():
    out = _decompress_batch({"image": torch.tensor([[0.5, -2.25]], dtype=torch.float16),
                             "midi": torch.tensor([[127, 128]], dtype=torch.int16),
                             "name": ["a"]})
    assert out["image"].dtype == torch.float32 and out["midi"].dtype == torch.int32
    assert out["midi"].tolist() == [[127, 128]] and out["name"] == ["a"]


class _W(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w, dtype=torch.float32))


def _run_both(w0, grads, k, clip=None, ema=None, lr=1e-2):
    """Apply the same gradient sequence on both sides; yield (port, jax) after each."""
    m = _W(w0)
    st = TrainState(m, make_adamw(lr, grad_clip=clip, accumulate_grad_batches=k),
                    ema_decay=ema)
    jst = JState.create({"w": jnp.asarray(w0, jnp.float32)},
                        j_adamw(lr, grad_clip=clip, accumulate_grad_batches=k), ema_decay=ema)
    for g in grads:
        m.w.grad = torch.tensor(g, dtype=torch.float32)
        st.apply_gradients()
        jst = jst.apply_gradients({"w": jnp.asarray(g, jnp.float32)})
        yield st, jst


@pytest.mark.parametrize("clip", [None, 1.0])
def test_accumulation_k_micro_equals_one_mean_step(clip):
    w0, xs = [2.0, 2.0, 2.0], [0.5, 1.5, 2.5, 3.5]
    grads = [[w - x for w in w0] for x in xs]  # grad of 0.5 * ||w - x||^2 at w0
    *_, (st, jst) = _run_both(w0, grads, k=4, clip=clip)
    np.testing.assert_allclose(st.model.w.detach().numpy(), np.asarray(jst.params["w"]),
                               atol=1e-6)
    mean = np.mean(grads, axis=0)
    *_, (full, _) = _run_both(w0, [mean], k=1, clip=clip)
    np.testing.assert_allclose(st.model.w.detach().numpy(), full.model.w.detach().numpy(),
                               atol=1e-6)
    assert st.step == 4 and st.updates == 1


def test_params_frozen_between_applies():
    for i, (st, jst) in enumerate(_run_both([0.0, 0.0], [[1.0, 1.0]] * 3, k=3)):
        np.testing.assert_allclose(st.model.w.detach().numpy(), np.asarray(jst.params["w"]),
                                   atol=1e-7)
        assert (st.model.w.detach().abs().max().item() == 0.0) == (i < 2)


def test_ema_ticks_per_optimizer_step_under_accumulation():
    steps = _run_both([0.0, 0.0], [[1.0, 1.0], [1.0, 1.0], [-2.0, 0.5], [0.3, 0.3]], k=2,
                      ema=0.9999, lr=1e-1)
    for i, (st, jst) in enumerate(steps):  # the port's state is updated in place
        assert st.ema.num_updates == int(jst.ema.num_updates) == (i + 1) // 2
        np.testing.assert_allclose(st.ema.shadow["w"].numpy(), np.asarray(jst.ema.shadow["w"]),
                                   rtol=1e-5, atol=1e-7)
    assert not np.allclose(st.ema.shadow["w"].numpy(), 0.0)
    trained = st.model.w.detach().clone()
    with ema_scope(st) as m:
        torch.testing.assert_close(m.w.detach(), st.ema.shadow["w"])
    torch.testing.assert_close(st.model.w.detach(), trained)  # restored on exit


def test_converter_maps_a_gradient_tree():
    """A jax.grad tree has the params' structure (``{"params": ...}``); the
    converter maps it leaf for leaf: grad of sum(p^2) is 2p on both sides."""
    torch.manual_seed(3)
    from versband_tpu_torch.models.dit import BandMoeDiT

    model = BandMoeDiT(**DIT)
    params = to_jax(model, "dit")
    grads = jax.grad(lambda p: sum(jnp.sum(x ** 2) for x in jax.tree_util.tree_leaves(p)))(
        params)
    mapped = state_dict_from_jax(grads, "dit")
    sd = model.state_dict()
    assert set(mapped) == set(sd)
    for k, v in sd.items():
        np.testing.assert_allclose(mapped[k].numpy(), 2 * v.numpy(), rtol=1e-6, err_msg=k)
