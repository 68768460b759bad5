"""The port's Time/Freq-MoE DiT (``versband_tpu_torch/models/dit_timefreq.py``)
against ``versband_tpu/models/dit_timefreq.py`` (fp32, CPU).

Weights go JAX -> port through ``state_dict_from_jax(..., "dit")`` (the JAX
converter has no rule for the stacked ``time_experts``: see
tests/test_torch_port_convert.py). The adaLN-zero layers, the final layer
and the attention gates of the JAX init are set off zero (every all-zero
leaf), so the blocks count. Bars: the DiT's 5e-4 max|d|; the MoE alone 1e-5
of its output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models import dit_timefreq as jtf
from versband_tpu_torch.models import dit_timefreq as ttf
from versband_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_concat_dit import perturb_zeros

TOL = 5e-4
KW = dict(in_channels=4, context_dim=12, hidden_size=16, depth=2, num_heads=2, max_len=32,
          num_experts=4, multiple_of=8)


@pytest.mark.parametrize("E,want", [(4, [0, 0, 0, 0, 1, 3]), (8, [0, 0, 1, 1, 2, 7])])
def test_hard_time_routing(E, want):
    t = torch.tensor([0.0, 124.0, 125.0, 249.0, 250.0, 999.0])
    assert ttf.time_expert_index(t, E).tolist() == want
    # a timestep past the last bucket stays on the last expert
    assert ttf.time_expert_index(torch.tensor([1000.0, 1500.0]), E).tolist() == [E - 1] * 2


def _moe_state(params):
    sd = state_dict_from_jax({"blocks_0": {"feed_forward": params["params"]}}, "dit")
    pre = "layers.0.feed_forward."
    return {k[len(pre):]: v for k, v in sd.items()}


@pytest.mark.parametrize("E", [4, 8])
def test_time_freq_moe_matches_jax(E):
    d = 16
    rng = np.random.RandomState(E)
    x = rng.randn(6, 5, d).astype(np.float32)
    t = np.array([0.0, 124.0, 125.0, 249.0, 250.0, 999.0], np.float32)
    jm = jtf.TimeFreqMoE(dim=d, hidden_dim=4 * d, num_experts=E, multiple_of=8)
    params = jm.init(jax.random.PRNGKey(E), jnp.asarray(x), jnp.asarray(t))
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(t))
    m = ttf.TimeFreqMoE(d, 4 * d, E, 8)
    m.load_state_dict(_moe_state(params))
    with torch.no_grad():
        out = m(torch.from_numpy(x), torch.from_numpy(t))
    scale = float(np.abs(np.asarray(ref)).max())
    err = float(np.abs(out.numpy() - np.asarray(ref)).max())
    assert scale > 0 and err <= 1e-5 * scale, (err, scale)


def test_stacked_swiglu_dense_per_expert_input():
    """The 4-D form runs expert e on x[e]; the 3-D form shares x."""
    from versband_tpu_torch.models.dit import StackedSwiGLU

    torch.manual_seed(0)
    s = StackedSwiGLU(3, 8, 32, 8)
    x = torch.randn(3, 2, 5, 8)
    out = s.dense(x)
    for e in range(3):
        torch.testing.assert_close(out[e], s[e](x[e]), rtol=0, atol=0)
    torch.testing.assert_close(s.dense(x[0]), torch.stack([s[e](x[0]) for e in range(3)]))
    with pytest.raises(ValueError, match="expert inputs"):
        s.dense(x[:2])


@pytest.fixture(scope="module")
def pair():
    jm = jtf.TimeFreqMoeDiT(**KW)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 16).astype(np.float32)
    ctx = rng.randn(2, 5, 12).astype(np.float32)
    params = perturb_zeros(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.zeros((2,)),
                                   jnp.asarray(ctx)), 3)
    m = ttf.TimeFreqMoeDiT(**KW).eval()
    m.load_state_dict(state_dict_from_jax(params, "dit"))
    return jm, params, m, x, ctx


@pytest.mark.parametrize("t", [[10.0, 800.0], [249.0, 250.0]])
@pytest.mark.parametrize("wrapped", [False, True])
def test_time_freq_dit_matches_jax(pair, t, wrapped):
    jm, params, m, x, ctx = pair
    t = np.asarray(t, np.float32)
    jctx = {"c_crossattn": jnp.asarray(ctx)} if wrapped else jnp.asarray(ctx)
    ref, jlb = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t), jctx)
    tctx = {"c_crossattn": torch.from_numpy(ctx)} if wrapped else torch.from_numpy(ctx)
    with torch.no_grad():
        out, lb = m(torch.from_numpy(x), torch.from_numpy(t), tctx)
    assert out.shape == (2, 4, 16) and float(jlb) == lb == 0.0
    assert np.abs(np.asarray(ref)).max() > 1e-2
    err = float(np.abs(out.numpy() - np.asarray(ref)).max())
    assert err < TOL, err
