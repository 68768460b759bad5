"""The routed expert path of the port's Band-MoE (``moe_eval_routed``) against
``versband_tpu.models.dit`` (its ``ragged_dot`` path) and against the port's
own dense path (fp32, CPU).

At eval (``key=None``, no Gumbel noise) routing is an argmax, so every token
must run the same expert on both sides. Bars: the stacked experts alone
1e-5; the whole DiT 5e-4, the DiT bar of docs/PARITY.md (the routed sums run
in another order than the dense einsums, through two blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models.dit import BandMoeDiT as JDiT, StackedSwiGLU as JStacked
from versband_tpu_torch.models import dit as tdit
from torch_port_helpers import (DIT_TINY, dit_inputs, jax_context, load_from_jax,
                                perturb_zero_init, to_jax, torch_context)

DIT_TOL = 5e-4


@pytest.mark.parametrize("E,skew", [(4, False), (4, True), (3, False)])
def test_routed_experts_match_ragged_dot(E, skew):
    """Segments of every size, an empty one among them when ``skew``."""
    d, hidden, mult = 16, 16, 8
    rng = np.random.RandomState(E + skew)
    x = rng.randn(2, 7, d).astype(np.float32)
    idx = rng.randint(0, E, (2, 7))
    if skew:
        idx[idx == 1] = 0  # expert 1 gets no token
    jm = JStacked(E, d, hidden, mult)
    p = jm.init(jax.random.PRNGKey(E), jnp.asarray(x))
    tm = load_from_jax(tdit.StackedSwiGLU(E, d, hidden, mult),
                       {"params": {"feed_forward": {"caption_experts": p["params"]}}},
                       "blocks_0", "layers.0.feed_forward.caption_experts.")
    with torch.no_grad():
        got = tm.routed(torch.from_numpy(x), torch.from_numpy(idx))
        dense = tm.dense(torch.from_numpy(x))  # [E, B, T, d]
    ref = jm.apply(p, jnp.asarray(x), idx=jnp.asarray(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    picked = np.take_along_axis(dense.numpy(), idx[None, :, :, None], axis=0)[0]
    np.testing.assert_allclose(got.numpy(), picked, atol=1e-5, rtol=1e-5)


def _pair(seed):
    torch.manual_seed(seed)
    routed = tdit.BandMoeDiT(**DIT_TINY, moe_eval_routed=True).eval()
    perturb_zero_init(routed, seed)
    dense = tdit.BandMoeDiT(**DIT_TINY).eval()
    dense.load_state_dict(routed.state_dict())
    return routed, dense


def test_routed_dit_matches_jax_at_eval():
    routed, _ = _pair(0)
    params = to_jax(routed, "dit")
    x, t, midi, beats, cap = dit_inputs(np.random.RandomState(0), 2, 16, 12, 4)
    with torch.no_grad():
        out, lb = routed(torch.from_numpy(x), torch.from_numpy(t),
                         torch_context(midi, beats, cap))
    ref, ref_lb = JDiT(**DIT_TINY, moe_eval_routed=True).apply(
        params, jnp.asarray(x), jnp.asarray(t), jax_context(midi, beats, cap))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=DIT_TOL, rtol=DIT_TOL)
    np.testing.assert_allclose(float(lb), float(ref_lb), atol=DIT_TOL, rtol=DIT_TOL)
    assert np.abs(out.numpy()).max() > 1e-2


def test_routed_dit_equals_the_dense_path():
    routed, dense = _pair(1)
    x, t, midi, beats, cap = dit_inputs(np.random.RandomState(1), 2, 16, 12, 4)
    calls = []
    orig = tdit.StackedSwiGLU.routed

    def counted(self, *a):
        calls.append(1)
        return orig(self, *a)

    tdit.StackedSwiGLU.routed = counted
    try:
        with torch.no_grad():
            a, la = routed(torch.from_numpy(x), torch.from_numpy(t),
                           torch_context(midi, beats, cap))
            b, lb = dense(torch.from_numpy(x), torch.from_numpy(t),
                          torch_context(midi, beats, cap))
    finally:
        tdit.StackedSwiGLU.routed = orig
    assert len(calls) == 2 * DIT_TINY["depth"]  # caption and acoustic experts per block
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=DIT_TOL, rtol=DIT_TOL)
    assert float(la) == pytest.approx(float(lb), rel=1e-6)


def test_training_mode_stays_dense():
    routed, dense = _pair(2)
    routed.train()
    dense.train()
    x, t, midi, beats, cap = dit_inputs(np.random.RandomState(2), 2, 16, 12, 4)
    a, _ = routed(torch.from_numpy(x), torch.from_numpy(t), torch_context(midi, beats, cap),
                  train=True)
    b, _ = dense(torch.from_numpy(x), torch.from_numpy(t), torch_context(midi, beats, cap),
                 train=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
