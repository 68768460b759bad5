"""The port's classic samplers (``versband_tpu_torch/models/samplers.py``)
against ``versband_tpu/models/samplers.py`` over a tiny ``BandMoeDiT`` (fp32,
CPU), the weights converted from the port.

JAX's draws are handed to the port: the start noise from ``split(key)[0]``
(PLMS: ``key`` itself) and each step's draw from ``fold_in(k_loop, i)``.
The schedule has 50 timesteps. Bar: the DiT's, 5e-4 max|d| on the samples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models import samplers as js
from versband_tpu.models.dit import BandMoeDiT as JDiT
from versband_tpu.models.schedules import DiffusionSchedule as JSchedule
from versband_tpu_torch.models import samplers as ts
from versband_tpu_torch.models.dit import BandMoeDiT
from versband_tpu_torch.models.schedules import DiffusionSchedule
from torch_port_helpers import (DIT_TINY, dit_inputs, jax_context, perturb_zero_init, to_jax,
                                torch_context)

TOL = 5e-4
T_STEPS = 50
B, T_MEL = 2, 16
SHAPE = (B, DIT_TINY["in_channels"], T_MEL // 2)


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    dit = BandMoeDiT(**DIT_TINY).eval()
    perturb_zero_init(dit, 0)
    japply = jax.jit(JDiT(**DIT_TINY).apply)
    params = to_jax(dit, "dit")
    rng = np.random.RandomState(3)
    _, _, midi, beats, cap = dit_inputs(rng, B, T_MEL, DIT_TINY["ori_dim"], 4)
    _, _, u_midi, u_beats, u_cap = dit_inputs(rng, B, T_MEL, DIT_TINY["ori_dim"], 4)
    return dict(
        dit=dit, japply=lambda p, x, t, c: japply(p, x, t, c), params=params,
        sched=DiffusionSchedule.create(T_STEPS, "linear", 0.00085, 0.012),
        jsched=JSchedule.create(T_STEPS, "linear", 0.00085, 0.012),
        ctx=(torch_context(midi, beats, cap), jax_context(midi, beats, cap)),
        uctx=(torch_context(u_midi, u_beats, u_cap), jax_context(u_midi, u_beats, u_cap)))


def _model(dit):
    return lambda x, t, c: dit(x, t, c)


def _loop_draws(key, n, shape=SHAPE):
    """JAX's start noise and per-step draws for ``key`` (split, fold_in)."""
    k_init, k_loop = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(k_init, shape))
    steps = [np.asarray(jax.random.normal(jax.random.fold_in(k_loop, i), shape))
             for i in range(n)]
    return torch.from_numpy(x_T), lambda i: torch.from_numpy(steps[i])


def _close(got, ref, tol=TOL):
    err = float(np.abs(got.numpy() - np.asarray(ref)).max())
    assert err < tol, err
    return err


def _cfg(s, cfg):
    if not cfg:
        return dict(unconditional_guidance_scale=1.0, unconditional_conditioning=None), \
            dict(unconditional_guidance_scale=1.0, unconditional_conditioning=None)
    return (dict(unconditional_guidance_scale=2.5, unconditional_conditioning=s["uctx"][0]),
            dict(unconditional_guidance_scale=2.5, unconditional_conditioning=s["uctx"][1]))


def test_schedule_tables_are_float32_as_jax_reads_them(setup):
    s = setup
    sampler = ts.DDIMSampler(None, s["sched"])
    ref = js.DDIMSampler(None, s["jsched"]).make_schedule(10, ddim_eta=1.0)
    got = sampler.make_schedule(10, ddim_eta=1.0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert all(a.dtype == np.float32 for a in got[1:])
    np.testing.assert_array_equal(ts.lvlb_weights(s["sched"])[:2],
                                  ts.lvlb_weights(s["sched"])[[1, 1]])
    assert np.isfinite(ts.lvlb_weights(s["sched"])).all()


@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("cfg", [False, True])
def test_ddim_matches_jax(setup, eta, cfg):
    s = setup
    key = jax.random.PRNGKey(11)
    tkw, jkw = _cfg(s, cfg)
    ref = js.DDIMSampler(s["japply"], s["jsched"]).sample(
        s["params"], SHAPE, s["ctx"][1], key, S=10, eta=eta, **jkw)
    x_T, noise = _loop_draws(key, 10)
    got = ts.DDIMSampler(_model(s["dit"]), s["sched"]).sample(
        SHAPE, s["ctx"][0], S=10, eta=eta, x_T=x_T, noise=noise, **tkw)
    assert np.abs(np.asarray(ref) - x_T.numpy()).max() > 1e-2  # the model moved it
    _close(got, ref)


@pytest.mark.parametrize("S", [2, 3, 10])
@pytest.mark.parametrize("cfg", [False, True])
def test_plms_matches_jax(setup, S, cfg):
    """S 2 and 3 (3 and 4 uniform timesteps of 50) return from the warm-up;
    S 10 runs the 4th-order body. The model is called once per timestep and
    once more (the first step calls twice)."""
    s = setup
    key = jax.random.PRNGKey(5)
    tkw, jkw = _cfg(s, cfg)
    ref = js.PLMSSampler(s["japply"], s["jsched"]).sample(
        s["params"], SHAPE, s["ctx"][1], key, S=S, **jkw)
    calls = []

    def model(x, t, c):
        calls.append(float(t[0]))
        return s["dit"](x, t, c)

    x_T = torch.from_numpy(np.asarray(jax.random.normal(key, SHAPE)))
    got = ts.PLMSSampler(model, s["sched"]).sample(SHAPE, s["ctx"][0], S=S, x_T=x_T, **tkw)
    assert len(calls) == len(ts.make_ddim_timesteps("uniform", S, T_STEPS)) + 1
    _close(got, ref)


@pytest.mark.parametrize("cfg", [False, True])
def test_stochastic_encode_and_decode_match_jax(setup, cfg):
    s = setup
    tkw, jkw = _cfg(s, cfg)
    x0 = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jsam = js.DDIMSampler(s["japply"], s["jsched"])
    tsam = ts.DDIMSampler(_model(s["dit"]), s["sched"])
    jenc = jsam.stochastic_encode(jnp.asarray(x0), 6, key, ddim_num_steps=10)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, SHAPE, jnp.float32)))
    enc = tsam.stochastic_encode(torch.from_numpy(x0), 6, ddim_num_steps=10, noise=noise)
    _close(enc, jenc, 1e-6)
    ref = jsam.decode(s["params"], jenc, s["ctx"][1], 6, key, S=10, **jkw)
    got = tsam.decode(enc, s["ctx"][0], 6, S=10, **tkw)
    _close(got, ref)


def test_ancestral_loop_matches_jax(setup):
    s = setup
    key = jax.random.PRNGKey(8)
    ref = js.ddpm_sample_loop(s["japply"], s["params"], s["jsched"], SHAPE, s["ctx"][1], key)
    x_T, noise = _loop_draws(key, T_STEPS)
    got = ts.ddpm_sample_loop(_model(s["dit"]), s["sched"], SHAPE, s["ctx"][0], x_T=x_T,
                              noise=noise)
    _close(got, ref)


def test_basic_functions_match_jax(setup):
    s = setup
    rng = np.random.RandomState(4)
    x0, noise = rng.randn(2, *SHAPE).astype(np.float32)
    t = np.array([0, 37])
    args = [(jnp.asarray(a), torch.from_numpy(a)) for a in (x0, noise)]
    jq = js.q_sample(s["jsched"], args[0][0], jnp.asarray(t), args[1][0])
    q = ts.q_sample(s["sched"], args[0][1], torch.from_numpy(t), args[1][1])
    _close(q, jq, 1e-6)
    _close(ts.predict_start_from_noise(s["sched"], q, torch.from_numpy(t), args[1][1]),
           js.predict_start_from_noise(s["jsched"], jq, jnp.asarray(t), args[1][0]), 1e-6)
    for g, r in zip(ts.q_posterior(s["sched"], args[0][1], q, torch.from_numpy(t)),
                    js.q_posterior(s["jsched"], args[0][0], jq, jnp.asarray(t))):
        _close(g, r, 1e-6)
    # a host int t gives the same coefficients as a tensor
    _close(ts.q_sample(s["sched"], args[0][1][1:], 37, args[1][1][1:]), jq[1:], 1e-6)


@pytest.mark.parametrize("parameterization", ["eps", "x0"])
def test_ddpm_p_losses_matches_jax(setup, parameterization):
    """Index 0 of the VLB weight is index 1's (t holds a 0)."""
    s = setup
    rng = np.random.RandomState(6)
    x0, noise = rng.randn(2, *SHAPE).astype(np.float32)
    t = np.array([0, 31])
    _, jparts = js.ddpm_p_losses(
        s["japply"], s["params"], s["jsched"], jnp.asarray(x0), jnp.asarray(t), s["ctx"][1],
        jnp.asarray(noise), parameterization=parameterization, original_elbo_weight=0.1)
    _, parts = ts.ddpm_p_losses(
        _model(s["dit"]), s["sched"], torch.from_numpy(x0), torch.from_numpy(t), s["ctx"][0],
        torch.from_numpy(noise), parameterization=parameterization, original_elbo_weight=0.1)
    for k in ("loss_simple", "loss_vlb", "loss"):
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]), rtol=1e-5, err_msg=k)
