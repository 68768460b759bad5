"""The port's Band-MoE DiT against ``versband_tpu.models.dit`` (fp32, CPU).

The port's weights go to JAX through the JAX package's converter, so the
port's parameter names are held to the reference checkpoint's. Both sides
route deterministically (no Gumbel noise); hard routing is an argmax, so the
test also asserts that every token picked the same expert on both sides.
Tolerance 1e-4 (fp32 through two blocks, summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models.dit import BandMoeDiT as JDiT, StackedSwiGLU as JStacked
from versband_tpu_torch.models import dit as tdit
from torch_port_helpers import (
    DIT_TINY, dit_inputs, jax_context, load_from_jax, perturb_zero_init, to_jax,
    torch_context)

TOL = 1e-4


def _build(seed):
    torch.manual_seed(seed)
    model = tdit.BandMoeDiT(**DIT_TINY).eval()
    perturb_zero_init(model, seed)
    return model


def _gate_logits(model):
    """Forward hooks recording the per-token gate logits of every block."""
    logits = []
    for blk in model.layers:
        for lin in (blk.feed_forward.caption_gating_network,
                    blk.feed_forward.acoustic_gating_network):
            lin.register_forward_hook(lambda m, i, o: logits.append(o.detach().numpy()))
    return logits


def test_forward_matches_jax_with_same_routing():
    model = _build(0)
    logits = _gate_logits(model)
    params = to_jax(model, "dit")
    x, t, midi, beats, cap = dit_inputs(np.random.RandomState(0), 2, 16, 12, 4)
    with torch.no_grad():
        out, lb = model(torch.from_numpy(x), torch.from_numpy(t),
                        torch_context(midi, beats, cap))
    (ref, ref_lb), state = JDiT(**DIT_TINY).apply(
        params, jnp.asarray(x), jnp.asarray(t), jax_context(midi, beats, cap),
        capture_intermediates=True, mutable=["intermediates"])
    inter = state["intermediates"]
    for i in range(DIT_TINY["depth"]):
        ff = inter[f"blocks_{i}"]["feed_forward"]
        for j, name in enumerate(("caption_gate", "acoustic_gate")):
            jl = np.asarray(ff[name]["__call__"][0])
            np.testing.assert_array_equal(logits[2 * i + j].argmax(-1), jl.argmax(-1))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(lb), float(ref_lb), atol=TOL, rtol=TOL)
    assert np.abs(out.numpy()).max() > 1e-2  # not the all-zero adaLN-zero output


def test_encode_only_and_frame_reconciliation():
    model = _build(1)
    params = to_jax(model, "dit")
    jm = JDiT(**DIT_TINY)
    rng = np.random.RandomState(1)
    _, t, midi, beats, cap = dit_inputs(rng, 2, 16, 12, 4)
    enc = model(None, None, {**torch_context(midi, beats, cap), "encode_only": True})
    ref = jm.apply(params, jnp.zeros((2, 4, 8)), jnp.asarray(t),
                   {**jax_context(midi, beats, cap), "encode_only": True})
    assert set(enc) == set(ref) == {"acoustic", "caption", "cap_emb"}
    for k in enc:
        np.testing.assert_allclose(enc[k].detach().numpy(), np.asarray(ref[k]), atol=TOL,
                                   rtol=TOL)
    # a latent 2 frames longer / shorter than the acoustic stream (8 frames)
    for t_lat in (10, 6):
        x = rng.randn(2, 4, t_lat).astype(np.float32)
        with torch.no_grad():
            out, _ = model(torch.from_numpy(x), torch.from_numpy(t), {"c_encoded": enc})
        ref_out, _ = jm.apply(params, jnp.asarray(x), jnp.asarray(t),
                              {"c_encoded": {k: jnp.asarray(v) for k, v in ref.items()}})
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("band_diagonal", [False, True])
def test_stacked_experts(band_diagonal):
    E, d, hidden, mult = 4, 16, 16, 8
    x = np.random.RandomState(2).randn(2, 5, d).astype(np.float32)
    jm = JStacked(E, d, hidden, mult)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = load_from_jax(tdit.StackedSwiGLU(E, d, hidden, mult),
                       {"params": {"feed_forward": {"caption_experts": p["params"]}}},
                       "blocks_0", "layers.0.feed_forward.caption_experts.")
    with torch.no_grad():
        got = (tm.band_diagonal if band_diagonal else tm.dense)(torch.from_numpy(x))
    ref = jm.apply(p, jnp.asarray(x), band_diagonal=band_diagonal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_anneal_and_gumbel_softmax():
    from versband_tpu.models import dit as jd

    for step in (0, 1000, 50000):
        assert tdit.anneal_temperature(step) == pytest.approx(float(jd.anneal_temperature(step)),
                                                              rel=1e-6)
        assert tdit.anneal_loss_weight(step) == pytest.approx(float(jd.anneal_loss_weight(step)),
                                                              rel=1e-6)
    logits = np.random.RandomState(3).randn(3, 7, 4).astype(np.float32)
    for hard in (False, True):
        got = tdit.gumbel_softmax(torch.from_numpy(logits), 0.7, hard)
        ref = jd.gumbel_softmax(jnp.asarray(logits), 0.7, hard)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
