"""The arithmetic of the tensor-core flash-attention backward (K2, K3),
emulated in PyTorch on the CPU.

``versband_tpu_torch/ops/csrc/flash_attn_bwd.cu`` runs its five products on
the tensor cores. What that changes against the plain backward is emulated
here, tile by tile as the kernels go, and held to the plain backward at the
tolerances the kernels are held to on the card (max|emulation - plain| /
max|plain|: fp32 1e-4, bf16 1e-2):

* fp32 inputs: every operand is split into a TF32 head (mantissa rounded to
  10 bits, ties away from zero, as ``cvt.rna.tf32.f32`` rounds) and a tail
  (the exact rest, of which the tensor core reads the upper 10 mantissa
  bits); a product is tail.head + head.tail + head.head, the small terms
  summed apart, and tail.tail dropped. P and dS are split the same way when
  they become operands of the second products.
* bf16 inputs: products of bf16 operands with fp32 sums; P and dS are
  rounded to bf16 before the second products, each gradient once at the end.
* both: the streamed side goes in tiles (32 rows in fp32, 64 in bf16), each
  tile's share of a gradient summed apart and added to the running one; P is
  ``exp2`` of the log2(e)-scaled argument and exactly 0 on masked keys.

The products of TF32 or bf16 operands are exact in fp32, so the emulation
forms them in float64 and rounds each sum to fp32 once: it leaves out the
truncation of the tensor core's own accumulator, which only the card shows.
One case is also held to ``jax.grad`` through the JAX package's Pallas
kernels in interpret mode. Two more tests replay the register layouts of
``mma.sync`` to check how the kernels re-pack a score fragment as the A
operand of the next product. The emulation lives here, on no path of the
port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.ops.flash_attention import flash_attention as jax_flash
from versband_tpu_torch.ops import flash_attention as fa

from torch_port_helpers import split_tf32, tf32_round

K23_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # x max|plain|, as on the card
STREAM_ROWS = {torch.float32: 32, torch.bfloat16: 64}
LOG2E = 1.4426950408889634

# the five cases of chip_smoke.py's K2/K3 phase, at reduced size
CASES = {
    "training": ((2, 128, 128, 2, 96), None, None),
    "serving": ((2, 94, 94, 2, 96), None, None),
    "tq!=tk d64": ((2, 75, 130, 2, 64), None, None),
    "varlen+0": ((3, 70, 94, 2, 96), [94, 0, 38], None),
    "scale d128": ((2, 33, 100, 2, 128), None, 0.3),
    "d32 cut in tile": ((2, 130, 70, 2, 32), [70, 5], None),
}


def product(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """einsum ``eq`` of fp32-valued a and b as the kernels multiply them:
    bf16-valued operands directly; fp32 operands as three TF32 passes (or one,
    to show what the split buys). Sums in float64, rounded to fp32 once."""
    def mm(x, y):
        return torch.einsum(eq, x.double(), y.double())

    if passes == 0:
        return mm(a, b).float()
    ah, at = split_tf32(a)
    bh, bt = split_tf32(b)
    if passes == 1:
        return mm(ah, bh).float()
    return ((mm(at, bh) + mm(ah, bt)).float() + mm(ah, bh).float())


def emulate_bwd(q, k, v, kv_len, lse, delta, dout, scale, passes=3):
    """dq, dk, dv as K2 and K3 compute them, in q's type."""
    dtype = q.dtype
    bf16 = dtype == torch.bfloat16
    passes = 0 if bf16 else passes
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    rows = STREAM_ROWS[dtype]
    qf, kf, vf, of = (t.float() for t in (q, k, v, dout))
    lens = torch.full((B,), Tk) if kv_len is None else kv_len.clamp(0, Tk)

    def operand(x):  # P or dS on its way into a second product
        return x.bfloat16().float() if bf16 else x

    def probs(s, lo_q, hi_q, lo_k, hi_k):
        """P [B, H, q, k] of a tile from its scores; 0 on masked keys."""
        arg = (s * scale - lse[:, :, lo_q:hi_q, None]) * LOG2E
        valid = torch.arange(lo_k, hi_k)[None, :] < lens[:, None]  # [B, k]
        return torch.where(valid[:, None, None, :], torch.exp2(arg), torch.zeros(()))

    # K2: a block owns query rows, streams keys; rows are independent, so all
    # query rows go at once
    dq = torch.zeros(B, Tq, H, D)
    for n0 in range(0, int(lens.max()), rows):
        n1 = min(n0 + rows, Tk)
        s = product("bqhd,bkhd->bhqk", qf, kf[:, n0:n1], passes)
        dp = product("bqhd,bkhd->bhqk", of, vf[:, n0:n1], passes)
        p = probs(s, 0, Tq, n0, n1)
        ds = operand(p * (dp - delta[..., None]))
        dq = dq + product("bhqk,bkhd->bqhd", ds, kf[:, n0:n1], passes)
    dq = dq * scale

    # K3: a block owns key rows, streams queries (scores transposed there;
    # the sums are the same)
    dk, dv = torch.zeros(B, Tk, H, D), torch.zeros(B, Tk, H, D)
    for m0 in range(0, Tq, rows):
        m1 = min(m0 + rows, Tq)
        s = product("bqhd,bkhd->bhqk", qf[:, m0:m1], kf, passes)
        dp = product("bqhd,bkhd->bhqk", of[:, m0:m1], vf, passes)
        p = probs(s, m0, m1, 0, Tk)
        ds = operand(p * (dp - delta[:, :, m0:m1, None]))
        dv = dv + product("bhqk,bqhd->bkhd", operand(p), of[:, m0:m1], passes)
        dk = dk + product("bhqk,bqhd->bkhd", ds, qf[:, m0:m1], passes)
    dk = dk * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _inputs(name, dtype):
    (B, Tq, Tk, H, D), lens, scale = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    q, k, v, dout = (torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32)).to(dtype)
                     for T in (Tq, Tk, Tk, Tq))
    kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    return q, k, v, dout, kv_len, (1.0 / math.sqrt(D) if scale is None else scale)


def _emulated_and_plain(name, dtype, passes=3):
    q, k, v, dout, kv_len, scale = _inputs(name, dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, kv_len, scale)
    delta = fa._delta(out, dout)
    got = emulate_bwd(q, k, v, kv_len, lse, delta, dout, scale, passes)
    ref = fa.flash_attention_bwd_reference(q, k, v, kv_len, out, lse, dout, scale)
    return got, ref, kv_len


def _rel(a, b):
    return (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_arithmetic_holds_the_card_tolerance(name, dtype):
    got, ref, kv_len = _emulated_and_plain(name, dtype)
    for gname, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.isfinite(a).all(), gname
        assert _rel(a, b) <= K23_TOL[dtype], (gname, _rel(a, b))
    if kv_len is not None:
        for a in got:
            empty = (kv_len == 0).nonzero().flatten()
            assert (a[empty] == 0).all()  # kv_len = 0: exactly zero gradients
        dk, dv = got[1], got[2]
        for b, n in enumerate(kv_len.tolist()):
            assert (dk[b, n:] == 0).all() and (dv[b, n:] == 0).all()  # masked keys


def test_three_tf32_passes_keep_fp32_accuracy_and_one_pass_does_not():
    """The split has room to spare under 1e-4; a single TF32 product, the
    different result the port does not take, sits two orders above it."""
    three, ref, _ = _emulated_and_plain("training", torch.float32, passes=3)
    one, _, _ = _emulated_and_plain("training", torch.float32, passes=1)
    worst3 = max(_rel(a, b) for a, b in zip(three, ref))
    worst1 = max(_rel(a, b) for a, b in zip(one, ref))
    assert worst3 <= 1e-5, worst3
    assert worst1 >= 30 * worst3, (worst1, worst3)


def test_emulated_arithmetic_matches_jax_grad():
    """The same gradients as ``jax.grad`` through the JAX package's custom VJP
    (its Pallas kernels in interpret mode), within the card's fp32 tolerance."""
    q, k, v, dout, kv_len, scale = _inputs("varlen+0", torch.float32)
    got, _, _ = _emulated_and_plain("varlen+0", torch.float32)
    g = jnp.asarray(dout.numpy())

    def f(q, k, v):
        return jnp.sum(jax_flash(q, k, v, jnp.asarray(kv_len.numpy()), scale) * g)

    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        b = torch.from_numpy(np.asarray(b))
        assert _rel(a, b) <= K23_TOL[torch.float32], (name, _rel(a, b))
        assert (a[1] == 0).all() and (b[1] == 0).all()


def test_split_is_exact_to_21_bits_and_heads_are_tf32():
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(4096) * np.exp(rng.uniform(-20, 20, 4096)))
                         .astype(np.float32))
    head, tail = split_tf32(x)
    assert ((head.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((tail.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((head - x).abs() <= x.abs() * 2.0 ** -11).all()      # half a TF32 ulp
    assert ((head.double() + tail.double() - x.double()).abs()
            <= x.abs().double() * 2.0 ** -21).all()
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])  # halfway: away from zero
    assert tf32_round(ties).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


# ---- register layouts of mma.sync (PTX ISA, "Matrix fragments"), per lane:
# g = lane // 4, t = lane % 4.

def _c_fragment(mat):
    """A 16x8 fp32 accumulator tile as 32 lanes x (c0..c3)."""
    return [[mat[g, 2 * t], mat[g, 2 * t + 1], mat[g + 8, 2 * t], mat[g + 8, 2 * t + 1]]
            for g, t in ((lane // 4, lane % 4) for lane in range(32))]


def test_tf32_fragment_repack_permutes_keys_consistently():
    """m16n8k8: a lane's accumulator values sit at columns 2t, 2t+1 but its A
    values at k-slots t, t+4. The kernel feeds c0, c2, c1, c3 as a0..a3 and
    fetches rows 2t and 2t+1 of the tile as b0, b1: the product is F @ tile."""
    rng = np.random.RandomState(1)
    f, tile = rng.randn(16, 8), rng.randn(8, 8)  # F: 16 queries x 8 keys; tile: 8 keys x 8 dims
    frag = _c_fragment(f)
    a_mat, b_mat = np.zeros((16, 8)), np.zeros((8, 8))  # as the tensor core sees them
    for lane in range(32):
        g, t = lane // 4, lane % 4
        c0, c1, c2, c3 = frag[lane]
        a0, a1, a2, a3 = c0, c2, c1, c3                  # the re-pack
        a_mat[g, t], a_mat[g + 8, t], a_mat[g, t + 4], a_mat[g + 8, t + 4] = a0, a1, a2, a3
        b_mat[t, g], b_mat[t + 4, g] = tile[2 * t, g], tile[2 * t + 1, g]  # b0, b1
    np.testing.assert_allclose(a_mat @ b_mat, f @ tile, rtol=1e-12, atol=1e-12)


def test_bf16_fragment_repack_joins_two_accumulator_tiles():
    """m16n8k16: two 8-column accumulator tiles make one 16-deep A fragment,
    a0 = (c0, c1) and a1 = (c2, c3) of the first, a2, a3 of the second; B comes
    through ``ldmatrix.trans`` as rows (2t, 2t+1) and (2t+8, 2t+9) of the tile."""
    rng = np.random.RandomState(2)
    f, tile = rng.randn(16, 16), rng.randn(16, 8)
    lo, hi = _c_fragment(f[:, :8]), _c_fragment(f[:, 8:])
    a_mat, b_mat = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        a = [(lo[lane][0], lo[lane][1]), (lo[lane][2], lo[lane][3]),
             (hi[lane][0], hi[lane][1]), (hi[lane][2], hi[lane][3])]
        for (row, col), pair in zip(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                     (g + 8, 2 * t + 8)), a):
            a_mat[row, col], a_mat[row, col + 1] = pair
        for k0 in (2 * t, 2 * t + 8):                    # b0, b1: (k0, k0 + 1) x column g
            b_mat[k0, g], b_mat[k0 + 1, g] = tile[k0, g], tile[k0 + 1, g]
    np.testing.assert_allclose(a_mat @ b_mat, f @ tile, rtol=1e-12, atol=1e-12)
