"""The port's ConcatDiT family (``versband_tpu_torch/models/concat_dit.py``)
against ``versband_tpu/models/concat_dit.py`` (fp32, CPU).

Weights go JAX -> port through ``state_dict_from_jax(..., "concat_dit")``
and back through the JAX package's ``convert_state_dict(..., "concat_dit")``;
every all-zero leaf of the JAX init (the zero ``proj_out`` of each
TemporalTransformer, the biases) is set off zero first, so each block counts.
Bar: 2e-4 max|d| (the JAX package's own torch bar for this family,
tests/test_concat_dit_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models import concat_dit as jcd
from versband_tpu_torch.models import concat_dit as tcd
from versband_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import to_jax

TOL = 2e-4
B, IN, CTX, H, T = 2, 4, 12, 32, 20
KW = dict(in_channels=IN, context_dim=CTX, hidden_size=H, depth=2, num_heads=2, max_len=64)
TOKEN_IDS = np.array([[101, 7, 8, 1064, 9, 1064, 11, 102, 0],
                      [101, 5, 1064, 6, 7, 102, 0, 0, 0]], np.int64)
ORDERS = np.array([[2, 0, 5, 100], [1, 3, 100, 100]], np.int64)


def perturb_zeros(params, seed: int, std: float = 0.2):
    """Every all-zero leaf replaced by N(0, std) draws."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * std)
        if not np.any(np.asarray(x)) else x, params)


def _inputs(rng, name):
    x = rng.randn(B, IN, T).astype(np.float32)
    t = np.array([17.0, 431.0], np.float32)
    if name.startswith("ConcatOrder"):
        ctx = {"token_embedding": rng.randn(B, TOKEN_IDS.shape[1], CTX).astype(np.float32),
               "token_ids": TOKEN_IDS, "orders": ORDERS}
    elif name.startswith("Hybrid"):
        ctx = {"c_crossattn": rng.randn(B, 6, CTX).astype(np.float32),
               "c_concat": {"acoustic": rng.randint(0, 16, (B, 2, 2 * T + 1))}}
    else:
        ctx = rng.randn(B, 7, CTX).astype(np.float32)  # odd: array_split's uneven halves
    return x, t, ctx


def _tree(c, fn):
    return {k: _tree(v, fn) for k, v in c.items()} if isinstance(c, dict) else fn(c)


VARIANTS = [("ConcatDiT", {}), ("ConcatDiT2MLP", {}),
            ("HybridDiT2MLP", dict(code_num=16, codebook_num=2)),
            ("HybridDiT2MLP2", dict(code_num=16, codebook_num=2, cond_fuse="concat_cut")),
            ("HybridDiT2MLP2", dict(code_num=16, codebook_num=2, cond_fuse="concat_proj")),
            ("HybridDiT2MLP2", dict(code_num=16, codebook_num=2, cond_fuse="concat_proj",
                                    unit_upsample_rate=2.0)),
            ("ConcatOrderDiT", {}), ("ConcatOrderDiT2", dict(max_objs=4))]


@pytest.mark.parametrize("name,extra", VARIANTS,
                         ids=[f"{n}-{e.get('cond_fuse', '')}{e.get('unit_upsample_rate', '')}"
                              for n, e in VARIANTS])
def test_variant_matches_jax(name, extra):
    rng = np.random.RandomState(0)
    x, t, ctx = _inputs(rng, name)
    jm = getattr(jcd, name)(**KW, **extra)
    jctx = _tree(ctx, jnp.asarray)
    params = perturb_zeros(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.zeros((B,)),
                                   jctx), 2)
    ref, jlb = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t), jctx)

    tm = getattr(tcd, name)(**KW, **extra).eval()
    tm.load_state_dict(state_dict_from_jax(params, "concat_dit"))
    with torch.no_grad():
        out, lb = tm(torch.from_numpy(x), torch.from_numpy(t), _tree(ctx, torch.from_numpy))
    assert out.shape == (B, IN, T) and float(jlb) == lb == 0.0
    assert np.isfinite(np.asarray(ref)).all() and np.abs(np.asarray(ref)).max() > 1e-2
    err = float(np.abs(out.numpy() - np.asarray(ref)).max())
    assert err < TOL, err

    # the port's weights back through the JAX package's converter
    back = to_jax(tm, "concat_dit")
    again, _ = jax.jit(jm.apply)(back, jnp.asarray(x), jnp.asarray(t), jctx)
    err = float(np.abs(out.numpy() - np.asarray(again)).max())
    assert err < TOL, err


def test_order_index_per_token_matches_jax():
    rng = np.random.RandomState(4)
    ids = rng.choice([0, 101, 102, 1064, 7, 8, 9, 2000], size=(5, 23)).astype(np.int64)
    for case in (ids, TOKEN_IDS):
        ref_idx, ref_special = jcd._order_index_per_token(jnp.asarray(case))
        idx, special = tcd.order_index_per_token(torch.from_numpy(case))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(special.numpy(), np.asarray(ref_special))
    idx, special = tcd.order_index_per_token(torch.from_numpy(TOKEN_IDS))
    assert idx[0].tolist() == [0, 0, 0, 0, 1, 1, 2, 2, 2]
    assert special[0].tolist() == [True, False, False, True, False, True, False, True, True]


def test_concat_order_dit2_insertion_layout():
    """tests/test_legacy_backbones.py's case: the order token lands just
    before its '|', the tail is the pad-order embedding:
    [c0, c1, order(3), c2 (the '|'), c3, c4, pad, pad]."""
    torch.manual_seed(0)
    m = tcd.ConcatOrderDiT2(**{**KW, "depth": 1}, max_objs=3).eval()
    emb = torch.randn(1, 5, CTX)
    ctx = {"token_embedding": emb, "token_ids": torch.tensor([[101, 7, 1064, 8, 102]]),
           "orders": torch.tensor([[3, 100, 100]])}
    with torch.no_grad():
        got = m.caption_tokens(ctx)[0]
        c = m.c_embedder(emb)[0]
        table = m.order_embedding.weight
    want = torch.stack([c[0], c[1], table[3], c[2], c[3], c[4], table[100], table[100]])
    assert got.shape == (8, H)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_order_dit2_drops_overflow_into_the_trash_slot():
    """More separators than ``max_objs``: the tokens pushed past
    ``Tc + max_objs`` and their order tokens fall into the trash slot, as in
    JAX's scatter."""
    torch.manual_seed(1)
    m = tcd.ConcatOrderDiT2(**{**KW, "depth": 1}, max_objs=1).eval()
    ids = torch.tensor([[101, 1064, 5, 1064, 6, 102]])
    ctx = {"token_embedding": torch.randn(1, 6, CTX), "token_ids": ids,
           "orders": torch.tensor([[4]])}
    with torch.no_grad():
        got = m.caption_tokens(ctx)[0]
        c = m.c_embedder(ctx["token_embedding"])[0]
        table = m.order_embedding.weight
    # slots: 0 c0, 1 order(4), 2 c1 ('|'), 3 c2, 4 order(4), 5 c3 ('|'), 6 c4; c5 overflows
    want = torch.stack([c[0], table[4], c[1], c[2], table[4], c[3], c[4]])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("length", [1, 10, 63, 64])
def test_position_embedding_matches_jax(length):
    jpe = jcd.PositionEmbedding(64, 8)
    x = np.random.RandomState(length).randn(2, length, 8).astype(np.float32)
    params = jpe.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = jpe.apply(params, jnp.asarray(x))
    pe = tcd.PositionEmbedding(64, 8)
    pe.load_state_dict({"weight": torch.tensor(np.asarray(params["params"]["weight"]))})
    with torch.no_grad():
        out = pe(torch.from_numpy(x))
    assert out.shape == (2, length, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_concat_order_dit_out_of_range_order_is_nan_as_in_jax():
    """An order id past the table (a padded slot a token maps to) reads NaN,
    as flax's ``Embed`` (``jnp.take``, fill mode), instead of a device-side
    assert."""
    table = torch.arange(6.0).reshape(3, 2)
    rows = tcd.take_fill(table, torch.tensor([[0, 2, 3, -1, -4]]))
    ref = jnp.take(jnp.asarray(table.numpy()), jnp.asarray([[0, 2, 3, -1, -4]]), axis=0)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref))
