"""The arithmetic of the tensor-core flash-attention forward (K1), emulated in
PyTorch on the CPU.

``versband_tpu_torch/ops/csrc/flash_attn_fwd.cu`` runs both of its products on
the tensor cores. What that changes against the plain forward is emulated
here, key tile by key tile as the kernel goes, and held to the plain forward
at the tolerances the kernel is held to on the card (``chip_smoke.py``'s
``K1_TOL``: out fp32 1e-4, bf16 2e-2, absolute; ``K1_LSE_TOL``: lse 1e-4 on
rows with a valid key):

* fp32 inputs: q, K, P and V are split into a TF32 head (mantissa rounded to
  10 bits, ties away from zero, as ``cvt.rna.tf32.f32`` rounds) and a tail
  (the exact rest, of which the tensor core reads the upper 10 mantissa
  bits); a product is tail.head + head.tail + head.head with the small terms
  summed apart, tail.tail dropped; each key tile's P V is summed from zero and
  added to the rescaled running O.
* bf16 inputs: products of bf16 operands with fp32 sums; P is rounded to
  bf16 before P V; the output is rounded to bf16 once.
* both: the softmax runs in log2 units (``exp2`` of logits times scale *
  log2 e); keys stream in the kernel's tiles (fp32 32 keys, bf16 64), each
  tile's maximum rescaling the running (m, l, O).

The products of TF32 or bf16 operands are exact in fp32, so the emulation
forms them in float64 and rounds each sum to fp32 once: it leaves out the
truncation of the tensor core's own accumulator, which only the card shows.
One case is also held to the JAX package's Pallas kernel in interpret mode.
The last tests replay the ``ldmatrix`` addresses and ``mma.sync`` register
layouts the kernel uses, lane by lane, for both types. The emulation lives
here, on no path of the port.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.ops.flash_attention import _flash_fwd_impl
from versband_tpu_torch.ops import flash_attention as fa

from torch_port_helpers import split_tf32

K1_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # absolute, as on the card
K1_LSE_TOL = 1e-4
# keys per streamed tile of the kernel (flash_attn_fwd.cu, Cfg::BN)
BN = {torch.float32: 32, torch.bfloat16: 64}
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_BIG = float(torch.finfo(torch.float32).min)

# the cases of chip_smoke.py's K1 phase, at reduced size
CASES = {
    "serving": ((2, 94, 94, 2, 96), None, None),
    "training": ((2, 128, 128, 2, 96), None, None),
    "tq!=tk d64": ((2, 75, 130, 2, 64), None, None),
    "varlen+0": ((3, 50, 94, 2, 96), [94, 0, 38], None),
    "scale d128": ((2, 33, 100, 2, 128), None, 0.3),
    "d32 cut in tile": ((2, 130, 70, 2, 32), [70, 5], None),
}


def product(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """einsum ``eq`` of fp32-valued a and b as the kernel multiplies them:
    directly (passes 0: bf16-valued operands), as three TF32 passes with the
    small terms summed apart, or as one TF32 pass. Sums in float64, rounded
    to fp32 once per chain."""
    def mm(x, y):
        return torch.einsum(eq, x.double(), y.double())

    if passes == 0:
        return mm(a, b).float()
    ah, at = split_tf32(a)
    bh, bt = split_tf32(b)
    if passes == 1:
        return mm(ah, bh).float()
    return (mm(at, bh) + mm(ah, bt)).float() + mm(ah, bh).float()


def emulate_fwd(q, k, v, kv_len, scale, passes=3, bn=None):
    """(out in q's type, lse fp32 [B, H, Tq]) as K1 computes them."""
    dtype = q.dtype
    bf16 = dtype == torch.bfloat16
    passes = 0 if bf16 else passes
    bn = BN[dtype] if bn is None else bn
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    qf, kf, vf = (t.float() for t in (q, k, v))
    lens = [Tk] * B if kv_len is None else kv_len.clamp(0, Tk).tolist()
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E)
    out = torch.zeros(B, Tq, H, D)
    lse = torch.zeros(B, H, Tq)
    for b, n in enumerate(lens):
        o = torch.zeros(H, Tq, D)
        m = torch.full((H, Tq), NEG_BIG)
        l = torch.zeros(H, Tq)
        for k0 in range(0, n, bn):
            k1 = min(k0 + bn, Tk)  # rows past Tk are zero-filled, masked
            s = product("qhd,khd->hqk", qf[b], kf[b, k0:k1], passes) * scale_log2
            s = s.masked_fill(torch.arange(k0, k1) >= n, NEG_BIG)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            m = m_new
            if bf16:
                pv = product("hqk,khd->hqd", p.bfloat16().float(), vf[b, k0:k1], 0)
            else:
                pv = product("hqk,khd->hqd", p, vf[b, k0:k1], passes)
            o = o * alpha[..., None] + pv  # the tile's share summed from zero
        lc = l.clamp_min(1e-30)
        out[b] = (o / lc[..., None]).permute(1, 0, 2)
        lse[b] = torch.where(m == NEG_BIG, m, m * LN2) + lc.log()
    return out.to(dtype), lse


def _inputs(name, dtype):
    (B, Tq, Tk, H, D), lens, scale = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)) + 5)
    q, k, v = (torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32)).to(dtype)
               for T in (Tq, Tk, Tk))
    kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    return q, k, v, kv_len, (1.0 / math.sqrt(D) if scale is None else scale)


def _lse_err(lse, ref_lse, kv_len):
    rows = slice(None) if kv_len is None else kv_len > 0  # a row with no key has no lse
    return (lse[rows] - ref_lse[rows]).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_arithmetic_holds_the_card_tolerance(name, dtype):
    q, k, v, kv_len, scale = _inputs(name, dtype)
    out, lse = emulate_fwd(q, k, v, kv_len, scale)
    ref, ref_lse = fa._reference_fwd(q, k, v, kv_len, scale)
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.isfinite(lse).all()
    assert (out.float() - ref.float()).abs().max().item() <= K1_TOL[dtype]
    assert _lse_err(lse, ref_lse, kv_len) <= K1_LSE_TOL
    if kv_len is not None:
        for b in (kv_len == 0).nonzero().flatten().tolist():
            assert (out[b] == 0).all()  # kv_len = 0: exactly zero rows


def test_three_tf32_passes_keep_fp32_accuracy_and_one_pass_does_not():
    """The split has room to spare under 1e-4; a single TF32 product, the
    different result the port does not take, does not."""
    q, k, v, kv_len, scale = _inputs("training", torch.float32)
    ref, _ = fa._reference_fwd(q, k, v, kv_len, scale)
    three = (emulate_fwd(q, k, v, kv_len, scale, 3)[0] - ref).abs().max().item()
    one = (emulate_fwd(q, k, v, kv_len, scale, 1)[0] - ref).abs().max().item()
    assert three <= 1e-5, three
    assert one >= 30 * three and one > K1_TOL[torch.float32], (one, three)


@pytest.mark.parametrize("bn", [16, 32, 64])
def test_any_key_tile_size_gives_the_same_function(bn):
    """The online softmax over key tiles of any size, ragged lengths and an
    empty row included, is the same softmax to fp32 rounding: the tile size
    of either type is free to change."""
    q, k, v, kv_len, scale = _inputs("varlen+0", torch.float32)
    out, lse = emulate_fwd(q, k, v, kv_len, scale, bn=bn)
    ref, ref_lse = fa._reference_fwd(q, k, v, kv_len, scale)
    assert (out - ref).abs().max().item() <= 2e-6
    assert _lse_err(lse, ref_lse, kv_len) <= 2e-6
    assert (out[1] == 0).all()


def test_emulated_arithmetic_matches_the_pallas_kernel():
    """The same out and lse as the JAX package's ``_flash_fwd_impl`` (its
    Pallas kernel in interpret mode), within the card's fp32 tolerances."""
    q, k, v, kv_len, scale = _inputs("varlen+0", torch.float32)
    out, lse = emulate_fwd(q, k, v, kv_len, scale)
    ref, ref_lse = _flash_fwd_impl(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                   jnp.asarray(kv_len.numpy()), scale, 16, 32, True)
    ref = torch.from_numpy(np.array(ref))
    ref_lse = torch.from_numpy(np.array(ref_lse)[:, :, :q.shape[1], 0])
    assert (out - ref).abs().max().item() <= K1_TOL[torch.float32]
    assert _lse_err(lse, ref_lse, kv_len) <= K1_LSE_TOL
    assert (out[1] == 0).all() and (ref[1] == 0).all()


# ---- ldmatrix and mma.sync, lane by lane (PTX ISA, "Matrix fragments" and
# "ldmatrix"): g = lane // 4, t = lane % 4. Shared memory is modelled as an
# array of elements [rows, pitch]; a lane's address is (row, first element).

def _ldmatrix_x4(smem, addr, per_word, trans=False):
    """Registers of ldmatrix.x4 per lane: lane 8i + r gives the address of row
    r of matrix i (16 bytes: 8 bf16 or 4 fp32). Without .trans, register i of
    a lane holds 32-bit word t of row g of matrix i; with .trans (b16 only),
    elements (2t, g) and (2t + 1, g) of matrix i."""
    regs = []
    for lane in range(32):
        g, t = lane // 4, lane % 4
        out = []
        for i in range(4):
            if trans:
                rows = [addr[8 * i + 2 * t], addr[8 * i + 2 * t + 1]]
                out.append(tuple(smem[r, c + g] for r, c in rows))
            else:
                r, c = addr[8 * i + g]
                out.append(tuple(smem[r, c + t * per_word + e] for e in range(per_word)))
        regs.append(out)
    return regs


def _mma(c, a, b, k):
    """c (per lane [c0..c3]) += A B for m16n8k16 (k = 16, bf16 pairs) or
    m16n8k8 (k = 8, one TF32 value per register)."""
    A, B = np.zeros((16, k)), np.zeros((k, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        if k == 16:
            for j in range(2):
                A[g, 2 * t + j], A[g + 8, 2 * t + j] = a[lane][0][j], a[lane][1][j]
                A[g, 2 * t + 8 + j], A[g + 8, 2 * t + 8 + j] = a[lane][2][j], a[lane][3][j]
                B[2 * t + j, g], B[2 * t + 8 + j, g] = b[lane][0][j], b[lane][1][j]
        else:
            A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = (x[0] for x in a[lane])
            B[t, g], B[t + 4, g] = b[lane][0][0], b[lane][1][0]
    C = A @ B
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for r, (row, col) in enumerate(((g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t),
                                        (g + 8, 2 * t + 1))):
            c[lane][r] += C[row, col]


def _to_matrix(c):
    """A 16x8 accumulator tile from its per-lane c0..c3."""
    m = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        m[g, 2 * t], m[g, 2 * t + 1], m[g + 8, 2 * t], m[g + 8, 2 * t + 1] = c[lane]
    return m


def _zeros(n):
    return [[[0.0] * 4 for _ in range(32)] for _ in range(n)]


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
def test_fragment_addresses_and_layouts_give_q_kt_and_p_v(bf16):
    """One warp (warp 1 of 4, two m-tiles in bf16, one in fp32) over one key
    tile (bf16 64 keys, fp32 32) at D = 32, with the kernel's lane addresses: the S
    accumulators hold q k^T, and P V from the re-packed accumulators (bf16:
    two 8-key tiles per 16-deep A fragment, V by ldmatrix.trans; fp32: k-slot
    t as key 2t and slot t + 4 as key 2t + 1, V by scalar loads of rows 2t and
    2t + 1 at column g) holds S V."""
    D, RW, rw = 32, 4, 1
    MT, bn = (2, 64) if bf16 else (1, 32)
    vec = 8 if bf16 else 4                       # elements per 16 bytes
    per_word, ksteps, k = (2, D // 16, 16) if bf16 else (1, D // 8, 8)
    LD = D + vec
    rng = np.random.RandomState(3)
    q = np.zeros((16 * MT * RW, LD))
    q[:, :D] = rng.randn(16 * MT * RW, D)
    kt, vt = np.zeros((bn, LD)), np.zeros((bn, LD))
    kt[:, :D], vt[:, :D] = rng.randn(bn, D), rng.randn(bn, D)

    s = [_zeros(bn // 8) for _ in range(MT)]
    for kk in range(ksteps):
        qa = []
        for mt in range(MT):  # a_off: rows lane % 16 of the m-tile, 16 bytes more for lanes 16-31
            addr = [(rw * MT * 16 + mt * 16 + (lane & 15), (lane >> 4) * vec + kk * 2 * vec)
                    for lane in range(32)]
            qa.append(_ldmatrix_x4(q, addr, per_word))
        for np_ in range(bn // 16):  # b_off: keys 0-7 lo, 0-7 hi, 8-15 lo, 8-15 hi
            addr = [(np_ * 16 + ((lane >> 4) << 3) + (lane & 7),
                     ((lane >> 3) & 1) * vec + kk * 2 * vec) for lane in range(32)]
            x = _ldmatrix_x4(kt, addr, per_word)
            for mt in range(MT):
                _mma(s[mt][2 * np_], qa[mt], [r[0:2] for r in x], k)
                _mma(s[mt][2 * np_ + 1], qa[mt], [r[2:4] for r in x], k)
    for mt in range(MT):
        rows = q[(rw * MT + mt) * 16:(rw * MT + mt + 1) * 16, :D]
        got = np.concatenate([_to_matrix(c) for c in s[mt]], axis=1)
        np.testing.assert_allclose(got, rows @ kt[:, :D].T, rtol=1e-12, atol=1e-12)

    for mt in range(MT):
        o = _zeros(D // 8)
        if bf16:
            for j in range(bn // 16):
                a = [[tuple(s[mt][2 * j][lane][0:2]), tuple(s[mt][2 * j][lane][2:4]),
                      tuple(s[mt][2 * j + 1][lane][0:2]), tuple(s[mt][2 * j + 1][lane][2:4])]
                     for lane in range(32)]
                for dp in range(D // 16):
                    addr = [(j * 16 + (((lane >> 3) & 1) << 3) + (lane & 7),
                             (lane >> 4) * vec + dp * 16) for lane in range(32)]
                    x = _ldmatrix_x4(vt, addr, per_word, trans=True)
                    _mma(o[2 * dp], a, [r[0:2] for r in x], k)
                    _mma(o[2 * dp + 1], a, [r[2:4] for r in x], k)
        else:
            for nt in range(bn // 8):
                c = s[mt][nt]
                a = [[(c[lane][0],), (c[lane][2],), (c[lane][1],), (c[lane][3],)]
                     for lane in range(32)]
                for dt in range(D // 8):
                    b = [[(vt[nt * 8 + 2 * (lane % 4), dt * 8 + lane // 4],),
                          (vt[nt * 8 + 2 * (lane % 4) + 1, dt * 8 + lane // 4],)]
                         for lane in range(32)]
                    _mma(o[dt], a, b, k)
        p = np.concatenate([_to_matrix(c) for c in s[mt]], axis=1)
        got = np.concatenate([_to_matrix(c) for c in o], axis=1)
        np.testing.assert_allclose(got, p @ vt[:, :D], rtol=1e-12, atol=1e-12)
