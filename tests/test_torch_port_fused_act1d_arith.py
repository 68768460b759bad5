"""The arithmetic and index math of the fused alias-free Snake (K4),
emulated in numpy on the CPU.

``versband_tpu_torch/ops/csrc/fused_act1d.cu`` evaluates Snake's sin^2 by a
Cody-Waite reduction to [-pi/2, pi/2] (k = rint(theta / pi), r = (theta - k
pi_hi) - k pi_lo, both steps fmaf) and an odd polynomial of degree 11, and
blocks both FIRs in registers: a thread makes 4 neighbouring U pairs from
one window of 10 x samples (pairs at the row's edges by the clamped path;
the 6 pairs past a tile's 1024 one each by it), and 4 neighbouring outputs
from one window of 20 snaked samples. Both are
emulated here step by step in float32 (an fmaf as the exact float64
multiply-add rounded once) and held:

* the sin^2 to float64 sin^2 of the same float32 argument over theta in
  [-1e4, 1e4] and at multiples of pi and their neighbours one ulp away, to
  4e-7 (the polynomial's 1.1e-7 on sin twice, plus the rounding of r and of
  the products; the accurate sinf it replaces is within ~1.2e-7);
* the whole kernel to the plain version (``alias_free_snake_reference``) at
  the card's tolerance (``chip_smoke.py``'s ``K4_TOL``: fp32 2e-5 x max(1,
  max|plain|), bf16 1e-2 x max|plain|) at the four BigVGAN serving widths
  with T cut short (T below the 12 taps, at and across the 1024-sample tiles)
  and on Snake, SnakeBeta, logscale on and off.

The emulation lives here, on no path of the port.
"""

import numpy as np
import pytest
import torch

from versband_tpu_torch.ops import fused_act1d as fa1

K4_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}  # as on the card
K, Q, TILE, PAIRS, OUTS, XPAD = 12, 3, 1024, 4, 4, 8
NGROUPS = TILE // PAIRS  # one group of 4 pairs a thread; the 2Q pairs past them one each
NX, NS = 1040, 2064
# csrc/fused_act1d.cu's constants, as float32
INV_PI = np.float32(0.318309886183790672)
PI_HI = np.float32(3.14159274101257324)
PI_LO = np.float32(-8.74227766e-08)
S3, S5, S7, S9, S11 = (np.float32(v) for v in (-1.666666716e-01, 8.333331905e-03,
                                               -1.984091941e-04, 2.752792398e-06,
                                               -2.393252885e-08))
f32 = np.float32


def fma(a, b, c):
    """fmaf: a * b + c exactly (float64 holds the product of two float32),
    rounded once to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def reduced_sin(theta):
    """(sin(theta), r) as the kernel computes them: the Cody-Waite reduction
    r = theta - k pi in [-pi/2, pi/2], then the odd polynomial; sin^2(theta)
    = sin(r)^2 whatever the sign k gives it."""
    theta = np.asarray(theta, np.float32)
    k = np.rint(f32(theta * INV_PI)).astype(np.float32)
    r = fma(-k, PI_LO, fma(-k, PI_HI, theta))
    r2 = f32(r * r)
    p = fma(S11, r2, S9)
    for cf in (S7, S5, S3):
        p = fma(p, r2, cf)
    return fma(f32(r * r2), p, r), r


def sin2(theta):
    s, r = reduced_sin(theta)
    return f32(s * s), r


def snake(u, a, inv_b):
    """u + sin^2(a u) * inv_b: fmaf(inv_b * s, s, u)."""
    s, _ = reduced_sin(f32(a * u))
    return fma(f32(inv_b * s), s, u)


def test_sin2_over_a_wide_range():
    theta = np.linspace(-1e4, 1e4, 2_000_001, dtype=np.float64).astype(np.float32)
    got, r = sin2(theta)
    want = np.sin(theta.astype(np.float64)) ** 2
    assert np.abs(got - want).max() <= 4e-7
    assert np.abs(r).max() <= np.pi / 2 + 0.01  # inside the polynomial's interval


def test_sin2_at_multiples_of_pi():
    k = np.arange(-3200, 3201, dtype=np.float64)
    near = (k * np.pi).astype(np.float32)
    theta = np.concatenate([near, np.nextafter(near, np.float32(np.inf)),
                            np.nextafter(near, np.float32(-np.inf)),
                            ((k + 0.5) * np.pi).astype(np.float32)])
    got, _ = sin2(theta)
    want = np.sin(theta.astype(np.float64)) ** 2
    assert np.abs(got - want).max() <= 4e-7


def _up_pair(w, g):
    """(ye, yo) from windows w [..., 7] (x[m - Q .. m + Q]), the kernel's
    fmaf order."""
    ye = np.zeros(w.shape[:-1], np.float32)
    yo = np.zeros_like(ye)
    for ai in range(K // 2):
        ye = fma(g[K - 1 - 2 * ai], w[..., ai], ye)
        yo = fma(g[K - 2 - 2 * ai], w[..., ai + 1], yo)
    return ye, yo


def edge_pair(xs, t0, q, T, g, a, inv_b):
    """Pair q of the tile at t0 from the window of m = t0 - Q + q clamped to
    the row: at m < 0 both S(ye[0]), at m >= T both S(yo[T-1])."""
    m = t0 - Q + q
    mc = min(max(m, 0), T - 1)
    o = mc - t0 + XPAD - Q
    ye, yo = _up_pair(xs[:, o:o + 7], g)
    se, so = snake(ye, a, inv_b), snake(yo, a, inv_b)
    return np.stack([so if m >= T else se, se if m < 0 else so], axis=1)


def emulate_k4(x, alpha, beta, logscale):
    """x [B, C, T] (float32 values) -> out float32, tile by tile, group by
    group, with the kernel's index math and both stage-1 paths."""
    B, C, T = x.shape
    f = fa1.kaiser_sinc_filter1d(0.25, 0.3, K).astype(np.float32)
    g = f32(2.0) * f
    a = alpha.astype(np.float32)
    bt = beta.astype(np.float32)
    if logscale:
        a, bt = np.exp(a).astype(np.float32), np.exp(bt).astype(np.float32)
    inv_b = f32(1.0) / f32(bt + f32(1e-9))
    out = np.zeros((B, C, T), np.float32)
    rows = x.reshape(B * C, T)
    a_r = np.tile(a, B)[:, None]
    ib_r = np.tile(inv_b, B)[:, None]
    for t0 in range(0, T, TILE):
        j = np.arange(NX)
        xs = rows[:, np.clip(t0 - XPAD + j, 0, T - 1)]  # replicate padding of x
        ss = np.full((B * C, NS), np.nan, np.float32)
        for grp in range(NGROUPS):
            q0 = PAIRS * grp
            m0 = t0 - Q + q0
            s = np.zeros((B * C, 2 * PAIRS), np.float32)
            if m0 >= 0 and m0 + PAIRS <= T:
                w = xs[:, q0:q0 + 12]
                for p in range(PAIRS):
                    o = XPAD - 2 * Q + p
                    ye, yo = _up_pair(w[:, o:o + 7], g)
                    s[:, 2 * p] = snake(ye, a_r[:, 0], ib_r[:, 0])
                    s[:, 2 * p + 1] = snake(yo, a_r[:, 0], ib_r[:, 0])
            else:
                for p in range(PAIRS):
                    s[:, 2 * p:2 * p + 2] = edge_pair(xs, t0, q0 + p, T, g, a_r[:, 0],
                                                      ib_r[:, 0])
            ss[:, 2 * q0:2 * q0 + 2 * PAIRS] = s
        for q in range(TILE, TILE + 2 * Q):
            ss[:, 2 * q:2 * q + 2] = edge_pair(xs, t0, q, T, g, a_r[:, 0], ib_r[:, 0])
        for u in range(TILE // OUTS):
            u0 = OUTS * u
            w = ss[:, 2 * u0:2 * u0 + 20]
            assert not np.isnan(w).any()  # every sample read was written
            for o in range(OUTS):
                t = t0 + u0 + o
                if t >= T:
                    break
                acc = np.zeros(B * C, np.float32)
                for jj in range(K):
                    acc = fma(f[jj], w[:, 2 * o + jj + 1], acc)
                out.reshape(B * C, T)[:, t] = acc
    return out


def _check(B, C, T, dtype, beta_on, logscale, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(B, C, T).astype(np.float32)).to(dtype)
    if logscale:
        alpha, beta = (rng.randn(C).astype(np.float32) * 0.3 for _ in range(2))
    else:
        alpha, beta = (rng.rand(C).astype(np.float32) + 0.2 for _ in range(2))
    beta = beta if beta_on else alpha
    got = emulate_k4(x.float().numpy(), alpha, beta, logscale)
    got = torch.from_numpy(got).to(dtype).float()
    ref = fa1.alias_free_snake_reference(x, torch.from_numpy(alpha),
                                         torch.from_numpy(beta) if beta_on else None,
                                         logscale).float()
    big = ref.abs().max().item()
    scale = max(1.0, big) if dtype == torch.float32 else big
    assert (got - ref).abs().max().item() <= K4_TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,T", [(256, 7), (128, 11), (64, 1030), (32, 2100)])
def test_kernel_holds_the_card_tolerance_at_bigvgan_widths(C, T, dtype):
    _check(1, C, T, dtype, True, True, C + T)


@pytest.mark.parametrize("T", [1, 2, 5, 12, 1024, 1025])
@pytest.mark.parametrize("variant", ["snake", "snakebeta lin", "snake lin"])
def test_kernel_edges_and_variants(T, variant):
    _check(2, 3, T, torch.float32, variant.startswith("snakebeta"),
           not variant.endswith("lin"), T)


def test_large_alpha_arguments():
    """|alpha U| of tens to thousands: the reduction keeps sin^2 exact to
    fp32 where U is large, as the accurate sinf did."""
    rng = np.random.RandomState(0)
    x = (rng.randn(1, 4, 300) * 50).astype(np.float32)
    alpha = np.array([1.0, 10.0, 40.0, 3.0], np.float32)
    got = emulate_k4(x, alpha, alpha, False)
    ref = fa1.alias_free_snake_reference(torch.from_numpy(x), torch.from_numpy(alpha), None,
                                         False).numpy()
    assert np.abs(got - ref).max() <= K4_TOL[torch.float32] * max(1.0, np.abs(ref).max())
