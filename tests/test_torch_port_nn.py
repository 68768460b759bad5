"""The port's ``nn/core`` pieces against ``versband_tpu.nn`` (fp32, CPU).

Inputs are numpy arrays from a seed; weights are the JAX module's init,
carried into the port with ``state_dict_from_jax``. Tolerance 1e-5
(fp32, summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import versband_tpu.nn.core as jcore
import versband_tpu_torch.nn.core as tcore
from torch_port_helpers import load_from_jax

TOL = 1e-5


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_rmsnorm_modulate_timestep_embedding():
    x = _rand(0, 2, 5, 16)
    jm = jcore.RMSNorm(16, eps=1e-5)
    p = {"params": {"weight": jnp.asarray(_rand(1, 16))}}
    tm = load_from_jax(tcore.RMSNorm(16, eps=1e-5), p)
    _close(tm(torch.from_numpy(x)), jm.apply(p, jnp.asarray(x)))

    shift, scale = _rand(2, 2, 16), _rand(3, 2, 16)
    _close(tcore.modulate(*map(torch.from_numpy, (x, shift, scale))),
           jcore.modulate(*map(jnp.asarray, (x, shift, scale))))

    t = np.array([0.0, 17.0, 250.0], np.float32)
    for dim in (256, 33):
        _close(tcore.timestep_embedding(torch.from_numpy(t), dim),
               jcore.timestep_embedding(jnp.asarray(t), dim))
    # XLA's float32 exp is off the correctly rounded value by 1 ulp for some
    # frequencies (torch's is not), and t multiplies that into the phase:
    # at t = 999 the sinusoids may differ by ~999 * 6e-8 = 6e-5.
    t = np.array([999.0], np.float32)
    np.testing.assert_allclose(tcore.timestep_embedding(torch.from_numpy(t), 256).numpy(),
                               np.asarray(jcore.timestep_embedding(jnp.asarray(t), 256)),
                               atol=1e-4)


@pytest.mark.parametrize("gelu_tanh", [False, True])
def test_timestep_and_condition_embedders(gelu_tanh):
    t = np.array([3.0, 640.0], np.float32)
    jt = jcore.TimestepEmbedder(16)
    pt = jt.init(jax.random.PRNGKey(1), jnp.asarray(t))
    tt = load_from_jax(tcore.TimestepEmbedder(16), pt, "t_embedder", "t_embedder.")
    _close(tt(torch.from_numpy(t)), jt.apply(pt, jnp.asarray(t)))

    c = _rand(4, 2, 5, 12)
    jc = jcore.ConditionEmbedder(16, gelu_tanh=gelu_tanh)
    pc = jc.init(jax.random.PRNGKey(2), jnp.asarray(c))
    tc = load_from_jax(tcore.ConditionEmbedder(12, 16, gelu_tanh), pc, "c_embedder",
                       "c_embedder.")
    _close(tc(torch.from_numpy(c)), jc.apply(pc, jnp.asarray(c)))


def test_feedforward_and_hidden_rule():
    assert tcore.swiglu_hidden_dim(768) == jcore.swiglu_hidden_dim(768) == 512
    assert tcore.swiglu_hidden_dim(100, 8, 1.5) == jcore.swiglu_hidden_dim(100, 8, 1.5)
    x = _rand(5, 2, 7, 16)
    jf = jcore.FeedForward(16, 16, multiple_of=8)
    pf = jf.init(jax.random.PRNGKey(3), jnp.asarray(x))
    tf = load_from_jax(tcore.FeedForward(16, 16, multiple_of=8), pf)
    _close(tf(torch.from_numpy(x)), jf.apply(pf, jnp.asarray(x)))


def test_rope_tables_apply_and_length_check():
    for args in ((8, 16), (96, 40, 10000.0, 2.0, 3.0)):
        for a, b in zip(tcore.precompute_rope(*args), jcore.precompute_rope(*args)):
            np.testing.assert_array_equal(a, b)
    x = _rand(6, 2, 7, 3, 8)
    cos, sin = jcore.precompute_rope(8, 16)
    _close(tcore.apply_rope(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin)),
           jcore.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin)))
    with pytest.raises(ValueError, match="RoPE table"):
        tcore.apply_rope(torch.zeros(1, 17, 1, 8), torch.from_numpy(cos),
                         torch.from_numpy(sin))


@pytest.mark.parametrize("use_flash", [False, True])
def test_sdpa_and_attention_dispatch_with_mask(use_flash):
    q, k, v = _rand(7, 2, 6, 2, 8), _rand(8, 2, 9, 2, 8), _rand(9, 2, 9, 2, 8)
    mask = (np.arange(9)[None, :] < np.array([[9], [4]])).astype(np.float32)
    port = tcore.attention(*map(torch.from_numpy, (q, k, v, mask)), scale=0.7,
                           use_flash=use_flash)
    ref = jcore.attention(*map(jnp.asarray, (q, k, v, mask)), scale=0.7, use_flash=use_flash)
    _close(port, ref)


@pytest.mark.parametrize("n_kv_heads,qk_norm,use_flash",
                         [(None, False, True), (2, True, False), (1, False, False)])
def test_joint_attention(n_kv_heads, qk_norm, use_flash):
    B, T, D, H, Ty = 2, 7, 16, 4, 5
    x, y = _rand(10, B, T, D), _rand(11, B, Ty, D)
    cos, sin = jcore.precompute_rope(D // H, 32)
    jm = jcore.JointAttention(D, H, n_kv_heads, qk_norm, y_dim=D, use_flash=use_flash)
    args = (jnp.asarray(x), None, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(y))
    p = jm.init(jax.random.PRNGKey(4), *args)
    p["params"]["gate"] = jnp.asarray(_rand(12, H))  # zero at init
    tm = load_from_jax(
        tcore.JointAttention(D, H, n_kv_heads, qk_norm, y_dim=D, use_flash=use_flash), p)
    port = tm(torch.from_numpy(x), None, torch.from_numpy(cos), torch.from_numpy(sin),
              torch.from_numpy(y))
    _close(port, jm.apply(p, *args))
