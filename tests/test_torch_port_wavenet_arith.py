"""The arithmetic of the tensor-core WaveNet layer (K5), emulated in PyTorch
on the CPU.

``versband_tpu_torch/ops/csrc/fused_wavenet.cu`` runs both products of a
PWG residual layer on the tensor cores (``mma.sync`` m16n8k8 TF32). What that
changes against the plain layer is emulated here in the kernel's order and
held to the plain layer (``wavenet_layer_reference``) at the tolerances the
kernel is held to on the card (``chip_smoke.py``'s ``K5_TOL``: x' and skip'
each within 1e-5 x their largest plain value in fp32; in bf16 x' 1e-2, skip'
1e-5):

* every operand is split into a TF32 head (the mantissa cut to 10 bits: one
  AND, where K1-K3 round with ``cvt.rna``) and the exact rest, of which the
  tensor core reads the upper 10 mantissa bits; a k-step is three ``mma``:
  tail.head and head.tail into the small-term accumulator, then head.head
  into the chunk partial;
* an ``mma`` adds its exact sum of 8 products to its accumulator and rounds
  the result toward zero (the tensor core's accumulator truncates; the
  emulation can also round to nearest, to show what the chunk partials buy);
* the gate product runs in chunks of 4 k-steps (32 X rows; the last chunk of
  3R + A = 272 rows has 2), the skip/out product in 2 chunks of 4: each
  chunk's head.head from zero, added to the running fp32 sum once the chunk
  ends; the small terms run on in their own accumulator over all chunks;
* gate = (run + small) + b, z = tanh(a) * (tanh(b / 2) / 2 + 1 / 2) in fp32; then
  skip' = skip + ((run + small) + b_s), x' = (((run + small) + b_o) + x) * sqrt(1/2).

Widths are the shipped ones (R 64, G 64, S 64, A 80) at small T. One case is
also held to the JAX package's Pallas kernel in interpret mode. The last
tests replay the kernel's operand layouts lane by lane: the weights' mma
fragment order with the tanh and sigmoid rows of a gate unit 8 rows apart in
an m-tile, the z exchange, and the X staging (16-byte copies from the
aligned sample at or before a row's first, read at an offset; zero fill
outside [0, T)). The emulation lives here, on no path of the port.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.ops.fused_wavenet import fused_wavenet_layer as jax_fused
from versband_tpu_torch.ops import fused_wavenet as fw
from versband_tpu_torch.vocoder.pwg import ResidualBlock

from torch_port_helpers import split_tf32_trunc

K5_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-5)}  # (x', skip') as on the card
R, G2, S, A = 64, 128, 64, 80  # the shipped widths
G = G2 // 2
KC_STEPS = 4  # k-steps per chunk of the gate product (csrc: KC = 32 rows)
NT = 64  # samples per tile (csrc)
WARPS = 16  # warps of a block (csrc): 4 m-tile pairs x NG sample groups of WN n-tiles
NG = WARPS // 4
WN = NT // 8 // NG
RSQRT2 = torch.tensor(0.70710678118654752, dtype=torch.float32)


def _block(seed, d):
    torch.manual_seed(seed)
    blk = ResidualBlock(3, R, G2, S, A, d).eval()
    with torch.no_grad():  # biases and weights away from their init scale
        for p in blk.parameters():
            p.mul_(2.0)
    return blk


def _weights(blk):
    return (blk.conv.weight, blk.conv.bias, blk.conv1x1_aux.weight, blk.conv1x1_skip.weight,
            blk.conv1x1_skip.bias, blk.conv1x1_out.weight, blk.conv1x1_out.bias)


def _data(seed, B, T, dtype):
    rng = np.random.RandomState(seed)
    x, c, skip = (torch.from_numpy(rng.randn(B, n, T).astype(np.float32)) for n in (R, A, S))
    return x.to(dtype), c.to(dtype), skip


def round_toward_zero(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, truncate: bool) -> torch.Tensor:
    """acc [B, M, N] + a [M, 8] . b [B, 8, N]: the exact sum (the products of
    TF32 values are exact in float64), rounded once to fp32."""
    s = acc.double() + torch.einsum("mk,bkn->bmn", a.double(), b.double())
    return round_toward_zero(s) if truncate else s.float()


def product(w: torch.Tensor, xs: torch.Tensor, chunk_steps: int, truncate: bool):
    """w [M, K8] . xs [B, K8, N] as the kernel sums it: (run, small) in fp32."""
    B, K8, N = xs.shape
    run = torch.zeros(B, w.shape[0], N)
    small = torch.zeros_like(run)
    for k0 in range(0, K8, 8 * chunk_steps):
        part = torch.zeros_like(run)
        for k in range(k0, min(k0 + 8 * chunk_steps, K8), 8):
            ah, at = split_tf32_trunc(w[:, k:k + 8])
            bh, bt = split_tf32_trunc(xs[:, k:k + 8])
            small = mma(small, at, bh, truncate)
            small = mma(small, ah, bt, truncate)
            part = mma(part, ah, bh, truncate)
        run = run + part
    return run, small


def x_rows(x: torch.Tensor, c: torch.Tensor, d: int, K8: int) -> torch.Tensor:
    """X [B, K8, T] in fp32: x at t - d, t, t + d (zero outside [0, T)), then
    c, then zero rows."""
    B, _, T = x.shape
    xf = torch.nn.functional.pad(x.float(), (d, d))
    taps = [xf[..., s:s + T] for s in (0, d, 2 * d)]
    rows = torch.cat(taps + [c.float()], dim=1)
    return torch.nn.functional.pad(rows, (0, 0, 0, K8 - rows.shape[1]))


def emulate_k5(x, c, skip, weights, d, truncate=True):
    wg, bg, wso, bso = fw.pack_matrices(*weights)
    xs = x_rows(x, c, d, wg.shape[1])
    run, small = product(wg, xs, KC_STEPS, truncate)
    gate = (run + small) + bg[:, None]
    unit = torch.arange(2 * fw.HALF)
    tanh_rows = unit[(unit % 16) < 8]  # row r of an m-tile; r + 8 its sigmoid
    sig = (0.5 * torch.tanh(0.5 * gate[:, tanh_rows + 8]).double() + 0.5).float()  # fmaf
    z = torch.tanh(gate[:, tanh_rows]) * sig
    run, small = product(wso, z, KC_STEPS, truncate)
    v = (run + small) + bso[:, None]
    skip_out = skip + v[:, :S]
    x_out = ((v[:, fw.HALF:fw.HALF + R] + x.float()) * RSQRT2).to(x.dtype)
    return x_out, skip_out


def _errs(got, ref):
    return [((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
            for a, r in zip(got, ref)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [1, 4, 512])
def test_kernel_arithmetic_holds_the_card_tolerance(d, dtype):
    blk = _block(d, d)
    x, c, skip = _data(d, 2, 700, dtype)
    w = _weights(blk)
    with torch.no_grad():
        got = emulate_k5(x, c, skip, w, d)
        ref = fw.wavenet_layer_reference(x, c, skip, *w, d)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for err, tol in zip(_errs(got, ref), K5_TOL[dtype]):
        assert err <= tol, (err, tol)


def test_three_passes_are_needed_and_enough():
    """One TF32 pass misses the fp32 bar by far; three passes with the
    truncating accumulator stay inside it, within twice the error of
    rounding to nearest."""
    blk = _block(7, 2)
    x, c, skip = _data(7, 1, 640, torch.float32)
    w = _weights(blk)
    with torch.no_grad():
        ref = fw.wavenet_layer_reference(x, c, skip, *w, 2)
        trunc = max(_errs(emulate_k5(x, c, skip, w, 2, truncate=True), ref))
        nearest = max(_errs(emulate_k5(x, c, skip, w, 2, truncate=False), ref))
        wg, bg, wso, bso = fw.pack_matrices(*w)
        xs = x_rows(x, c, 2, wg.shape[1])
        one_pass = torch.einsum("mk,bkn->bmn", split_tf32_trunc(wg)[0].double(),
                                split_tf32_trunc(xs)[0].double()).float() + bg[:, None]
        dense = torch.einsum("mk,bkn->bmn", wg.double(), xs.double()).float() + bg[:, None]
    assert trunc <= 1e-5 and nearest <= trunc * 2 + 1e-7
    assert (one_pass - dense).abs().max() / dense.abs().max() > 1e-4


def test_emulation_matches_the_jax_kernel():
    d = 4
    blk = _block(11, d)
    x, c, skip = _data(11, 1, 1024, torch.float32)
    w = {k: v.detach().numpy() for k, v in zip(("wg", "bg", "wa", "ws", "bs", "wo", "bo"),
                                                _weights(blk))}

    def t(a):
        return jnp.asarray(a.numpy().transpose(0, 2, 1))

    jx, js = jax_fused(
        t(x), t(c), t(skip), jnp.asarray(w["wg"].transpose(2, 1, 0)), jnp.asarray(w["bg"]),
        jnp.asarray(w["wa"][:, :, 0].T), jnp.asarray(w["ws"][:, :, 0].T), jnp.asarray(w["bs"]),
        jnp.asarray(w["wo"][:, :, 0].T), jnp.asarray(w["bo"]), d, 1024, block_t=512,
        interpret=True)
    ref = [torch.from_numpy(np.array(a).transpose(0, 2, 1)) for a in (jx, js)]
    with torch.no_grad():
        got = emulate_k5(x, c, skip, _weights(blk), d)
    for err in _errs(got, ref):
        assert err <= 1e-5


def test_packed_fragments_lane_by_lane():
    """Each lane's four A values of every 16 x 8 fragment: lane 4g + t holds
    (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4). In the gate
    operand row g of m-tile m is the tanh row of unit 8m + g and row g + 8
    its sigmoid row, so the accumulator's c0/c1 (row g) and c2/c3 (row g + 8)
    of a lane are the two halves of one unit: z forms in the lane. Columns
    are x at t - d, t, t + d (tap-major), then c; in the skip/out operand the
    column is the unit, as z is written to shared memory (row 8m + g)."""
    blk = _block(3, 1)
    wg_f, bg, wso_f, bso = fw.pack_weights(*_weights(blk))
    w_gate = blk.conv.weight.detach()
    w_aux = blk.conv1x1_aux.weight.detach()[:, :, 0]
    w_skip = blk.conv1x1_skip.weight.detach()[:, :, 0]
    w_out = blk.conv1x1_out.weight.detach()[:, :, 0]
    K = 3 * R + A
    assert wg_f.shape == (8, -(-K // 8), 32, 4) and wso_f.shape == (8, 8, 32, 4)

    def gate_w(row, k):
        m, r = divmod(row, 16)
        unit = 8 * m + r % 8
        grow = unit if r < 8 else G + unit
        if unit >= G or k >= K:
            return 0.0
        return (w_gate[grow, k % R, k // R] if k < 3 * R else w_aux[grow, k - 3 * R]).item()

    def so_w(row, unit):
        if unit >= G:
            return 0.0
        if row < fw.HALF:
            return w_skip[row, unit].item() if row < S else 0.0
        return w_out[row - fw.HALF, unit].item() if row - fw.HALF < R else 0.0

    for frags, value, ksteps in ((wg_f, gate_w, wg_f.shape[1]), (wso_f, so_w, 8)):
        for m in range(8):
            for ks in range(ksteps):
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    want = [value(16 * m + g, 8 * ks + t), value(16 * m + g + 8, 8 * ks + t),
                            value(16 * m + g, 8 * ks + t + 4),
                            value(16 * m + g + 8, 8 * ks + t + 4)]
                    assert frags[m, ks, lane].tolist() == pytest.approx(want, abs=0), \
                        (m, ks, lane)
    # biases in the packed row order
    b = blk.conv.bias.detach()
    for row in range(128):
        m, r = divmod(row, 16)
        unit = 8 * m + r % 8
        assert bg[row].item() == (b[unit if r < 8 else G + unit].item() if unit < G else 0.0)
    assert torch.equal(bso[:S], blk.conv1x1_skip.bias.detach())
    assert torch.equal(bso[64:64 + R], blk.conv1x1_out.bias.detach())


def test_z_exchange_through_shared_memory():
    """The gate epilogue writes lane (g, t)'s z of unit 8m + g at samples
    n + 2t, n + 2t + 1 (its c0/c2 and c1/c3); the skip/out product reads B
    rows (units) 8ks + t and 8ks + t + 4 at sample n + g. Replayed for one
    tile: every z written once and read back as the value of its unit and
    sample."""
    zs = -np.ones((64, NT + 8))
    for warp in range(WARPS):
        mp, n_base = warp // NG, 8 * WN * (warp % NG)
        for m in range(2):
            mt = 2 * mp + m
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for j in range(WN):
                    for e in range(2):
                        unit, n = 8 * mt + g, n_base + 8 * j + 2 * t + e
                        assert zs[unit, n] == -1
                        zs[unit, n] = 1000 * unit + n
    assert (zs[:, :NT] >= 0).all() and (zs[:, NT:] == -1).all()
    for warp in range(WARPS):
        n_base = 8 * WN * (warp % NG)
        for ks in range(8):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for j in range(WN):
                    n = n_base + 8 * j + g
                    for unit in (8 * ks + t, 8 * ks + t + 4):
                        assert zs[unit, n] == 1000 * unit + n


@pytest.mark.parametrize("esize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T,d,t0", [(640, 1, 0), (640, 2, 576), (640, 3, 64), (640, 512, 128),
                                    (4096, 7, 2048), (96, 100, 0), (640, 4, 576)])
def test_x_staging_reads_every_tap(esize, T, d, t0):
    """The 16-byte staging of a row of tap shift s: pieces of VEC = 16 / esize
    samples from the aligned sample at or before t0 + s, zero where a piece
    lies outside [0, T) (T is a multiple of VEC on this path), read at offset
    ((s mod VEC) + VEC) mod VEC: sample n of the tile is x[t0 + s + n], or 0
    outside [0, T)."""
    vec = 16 // esize
    ld = 72 if esize == 4 else 80
    cpr = NT // vec + 1
    T = -(-T // vec) * vec
    x = np.arange(1, T + 1, dtype=np.float64)
    for shift in (-d, 0, d):
        off = ((shift % vec) + vec) % vec
        row = np.full(ld, np.nan)
        for j in range(cpr):
            s = t0 + shift - off + j * vec
            assert s % vec == 0
            row[j * vec:(j + 1) * vec] = x[s:s + vec] if 0 <= s and s + vec <= T else 0.0
        for n in range(NT):
            t = t0 + shift + n
            assert row[off + n] == (x[t] if 0 <= t < T else 0.0)


def test_any_tile_of_samples_gives_the_same_function():
    """Tiles are independent: the emulation over all samples at once equals
    the emulation tile by tile (64 samples, ragged last tile)."""
    blk = _block(5, 16)
    x, c, skip = _data(5, 1, 200, torch.float32)
    w = _weights(blk)
    with torch.no_grad():
        whole = emulate_k5(x, c, skip, w, 16)
        # each tile alone, with its taps read from the whole row
        xs = x_rows(x, c, 16, fw.pack_matrices(*w)[0].shape[1])
        tiles = [product(fw.pack_matrices(*w)[0], xs[..., n:n + NT], KC_STEPS, True)
                 for n in range(0, 200, NT)]
    run = torch.cat([t[0] for t in tiles], dim=-1)
    small = torch.cat([t[1] for t in tiles], dim=-1)
    full_run, full_small = product(fw.pack_matrices(*w)[0], xs, KC_STEPS, True)
    assert torch.equal(run, full_run) and torch.equal(small, full_small)
    assert math.isfinite(whole[0].abs().max().item())
