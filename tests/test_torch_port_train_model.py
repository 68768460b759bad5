"""The training half of the port's model against ``versband_tpu`` (fp32, CPU):
BandMoeDiT in training mode (soft routing, flash attention), the CFM loss,
the diffusion schedule and ``stochastic_encode``.

Both sides get the same weights (the port's, through the JAX package's
converter), inputs made with numpy from a seed, and the same random draws:
the JAX side's ``jax.random.gumbel`` is replaced, in the test only, by a
function that returns the numpy draws in call order. Gradients of the JAX
side come back through ``state_dict_from_jax``. Tolerance: loss 1e-5;
gradients 1e-4 of the largest gradient (fp32 through two blocks, summation
order, the JAX flash backward in interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models.cfm import CFM as JCFM, cfm_p_losses as j_p_losses
from versband_tpu.models.dit import BandMoeDiT as JDiT
from versband_tpu_torch.models.cfm import CFM, cfm_p_losses
from versband_tpu_torch.models.dit import BandMoeDiT
from torch_port_helpers import (
    DIT_TINY, Draws, assert_grads_match, dit_inputs, jax_context, perturb_zero_init, to_jax,
    torch_context)

DIT = {**DIT_TINY, "use_flash": True}
LOSS_TOL = 1e-5


def _model(seed=0, **kw):
    torch.manual_seed(seed)
    m = BandMoeDiT(**{**DIT, **kw})
    perturb_zero_init(m, seed)
    return m


def _gumbel(model, B, T, seed):
    rng = np.random.RandomState(seed)
    return [rng.gumbel(size=s).astype(np.float32) for s in model.gumbel_shapes(B, T)]


@pytest.mark.parametrize("noise", [False, True])
def test_training_forward_and_grads_match_jax(noise, monkeypatch):
    """train=True: soft routing, no noise (JAX without a 'gumbel' rng), or
    the same Gumbel draws on both sides in the JAX order."""
    model = _model(0)
    params = to_jax(model, "dit")
    B, t_mel = 2, 16
    x, t, midi, beats, cap = dit_inputs(np.random.RandomState(1), B, t_mel, 12, 4)
    w = np.random.RandomState(2).randn(B, 4, t_mel // 2).astype(np.float32)
    draws = _gumbel(model, B, t_mel // 2, 3) if noise else None
    if noise:
        monkeypatch.setattr(jax.random, "gumbel", Draws(draws))

    def jloss(p):
        out, lb = JDiT(**DIT).apply(p, jnp.asarray(x), jnp.asarray(t),
                                    jax_context(midi, beats, cap), step=7, train=True,
                                    rngs={"gumbel": jax.random.PRNGKey(0)} if noise else None)
        return jnp.sum(out * w) + lb

    ref_loss, ref_grads = jax.value_and_grad(jloss)(params)
    out, lb = model(torch.from_numpy(x), torch.from_numpy(t), torch_context(midi, beats, cap),
                    step=7, train=True,
                    gumbel=iter(torch.from_numpy(d) for d in draws) if noise else None)
    loss = (out * torch.from_numpy(w)).sum() + lb
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= LOSS_TOL * max(1.0, abs(float(ref_loss)))
    assert_grads_match(model, ref_grads)
    assert model.layers[0].attention.wq.weight.grad.abs().max() > 0


def test_remat_recomputes_with_the_same_noise():
    """remat (torch.utils.checkpoint per block) gives the gradients of the
    plain forward, Gumbel noise drawn from a generator included."""
    B, t_mel = 2, 16
    x, t, midi, beats, cap = dit_inputs(np.random.RandomState(4), B, t_mel, 12, 4)
    grads = []
    for remat in (False, True):
        model = _model(5, remat=remat)
        out, lb = model(torch.from_numpy(x), torch.from_numpy(t),
                        torch_context(midi, beats, cap), train=True,
                        gumbel=torch.Generator().manual_seed(6))
        (out.square().mean() + lb).backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("train", [False, True])
def test_cfm_p_losses_match_jax(train, monkeypatch):
    """cfm_p_losses (eval routing) and CFM.p_losses (training routing) with
    the same t, noise and Gumbel draws."""
    model = _model(8)
    params = to_jax(model, "dit")
    B, t_mel = 2, 16
    rng = np.random.RandomState(9)
    _, _, midi, beats, cap = dit_inputs(rng, B, t_mel, 12, 4)
    x_start = rng.randn(B, 4, t_mel // 2).astype(np.float32)
    noise = rng.randn(B, 4, t_mel // 2).astype(np.float32)
    t = np.array([3, 871])

    def cond(lib, m, b, c):
        return {"caption": lib(c), "acoustic": {"midi": lib(m), "beats": lib(b)}}

    jcond, tcond = cond(jnp.asarray, midi, beats, cap), cond(torch.from_numpy, midi, beats, cap)
    if train:
        draws = _gumbel(model, B, t_mel // 2, 10)
        monkeypatch.setattr(jax.random, "gumbel", Draws(draws))
        jm = JCFM(unet_config={"target": "versband_tpu.models.dit.BandMoeDiT", "params": DIT},
                  scale_by_std=False)
        ref_loss, ref_parts = jm.p_losses(params, jnp.asarray(x_start), jcond, jnp.asarray(t),
                                          jax.random.PRNGKey(0), step=3,
                                          noise=jnp.asarray(noise))
        cfm = CFM(device="cpu", scale_by_std=False)
        cfm.model = model
        loss, parts = cfm.p_losses(torch.from_numpy(x_start), tcond, torch.from_numpy(t),
                                   step=3, noise=torch.from_numpy(noise),
                                   gumbel=iter(torch.from_numpy(d) for d in draws))
    else:
        ref_loss, ref_parts = j_p_losses(JDiT(**DIT).apply, params, jnp.asarray(x_start), jcond,
                                         jnp.asarray(t), jnp.asarray(noise), step=3)
        loss, parts = cfm_p_losses(model, torch.from_numpy(x_start), tcond, torch.from_numpy(t),
                                   torch.from_numpy(noise), step=3)
    assert set(parts) == set(ref_parts) == {"loss", "loss_simple", "lb_loss"}
    for k in parts:
        assert abs(parts[k].item() - float(ref_parts[k])) <= LOSS_TOL, k
    assert abs(loss.item() - float(ref_loss)) <= LOSS_TOL


def test_diffusion_schedule_and_stochastic_encode_match_jax():
    from versband_tpu.models.schedules import DiffusionSchedule as JSched
    from versband_tpu_torch.models.schedules import DiffusionSchedule

    for kind in ("linear", "cosine", "sqrt_linear", "sqrt"):
        a = DiffusionSchedule.create(1000, kind, 0.00085, 0.012)
        b = JSched.create(1000, kind, 0.00085, 0.012)
        for f in a.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{kind} {f}")
    rng = np.random.RandomState(11)
    x0, noise = rng.randn(2, 2, 4, 8).astype(np.float32)
    jm, tm = JCFM(scale_by_std=False), CFM(device="cpu", scale_by_std=False)
    for t_index in (0, 7, 24):
        ref = jm.stochastic_encode(jnp.asarray(x0), t_index, jax.random.PRNGKey(0),
                                   noise=jnp.asarray(noise))
        got = tm.stochastic_encode(torch.from_numpy(x0), t_index, noise=torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
