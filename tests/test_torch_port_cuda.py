"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode. This file imports neither JAX nor the JAX package, so
it runs on a machine with only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances against the plain version: K1 fp32 1e-4 (both products as three
TF32 passes over split operands, 2^-21 of a term dropped, summed in another
order over up to 768 keys); bf16 2e-2 (the probabilities and the output are
rounded to bf16; outputs are O(1)); K1's log-sum-exp 1e-4 absolute on rows
with a key (fp32 on both sides from the same widened inputs). K2/K3 are held to their
plain backward as max|kernel - plain| / max|plain|: fp32 1e-4 (products as
three TF32 passes over split operands, 2^-21 of a term dropped, summed in
another order over up to 768 rows or keys); bf16 1e-2 (the kernels round P
and dS to bf16 before the second products and each gradient to bf16 once:
half an ulp is 2^-9 of a value).

K4 (fused alias-free Snake) against its plain version: fp32 2e-5 x max(1,
max|plain|) (the JAX test's bar: FIRs in another order, sin^2 by a reduced
polynomial within 2.3e-7); bf16 1e-2 x max|plain| (both sides compute in
fp32 from the same bf16 input and round the output to bf16 once). K5 (fused
WaveNet layer): x' and skip' each within 1e-5 x their largest plain value in
fp32 (JAX's bar: sums over 3R + A and G terms in another order, as three TF32
passes over split operands); in bf16, x' within 1e-2 x (rounded to bf16 once)
and skip' 1e-5 x (fp32 on both sides from the same widened inputs). The
plain versions' convolutions run with TF32 off.

The T5 caption tower (plain PyTorch) on the card against the CPU: 1e-5 (fp32,
TF32 off, products summed in another order). The inference CLI on a tiny
config, card (K1 in the DiT) against ``--platform cpu``, with the same start
noise: wavs within 1e-3 of full scale and the same ``clap.csv``. The
training CLI on a tiny config: K1, K2 and K3 counted per step and per
validation batch. One stage-1 VAE-GAN step (plain PyTorch, R1 double
backward) at tiny widths, card against CPU: losses 1e-5 relative, each
parameter's gradient 1e-4 of its own largest, floored at 1e-3 of the largest
of all (fp32, TF32 off, summed in another order), no kernel of K1-K4
launched.

The classic samplers over a small DiT (depth 4, head dim 32) on the card:
4 K1 launches per model call (one per block; CFG is one batch-doubled
call), the latents within 2e-3 of the CPU's from the same draws (fp32,
TF32 off, summation order through 4 blocks over 10 steps). CLAP (Cnn14 and the BERT
caption tower, plain PyTorch) on the card against the CPU: 1e-4 of the
embeddings' scale.
"""

import math

import numpy as np
import pytest
import torch

from versband_tpu_torch.ops import flash_attention as fa
from versband_tpu_torch.ops import fused_act1d as fa1
from versband_tpu_torch.ops import fused_wavenet as fw

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
K4_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
K5_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-5)}  # (x', skip')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(cuda, dtype, B, Tq, Tk, H, D, seed=5):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32)).to(cuda, dtype)
            for T in (Tq, Tk, Tk)]


def _check(q, k, v, kv_len=None, scale=None):
    before = fa.LAUNCHES
    out, lse = fa.flash_attention_fwd(q, k, v, kv_len, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ref, ref_lse = fa._reference_fwd(q, k, v, kv_len,
                                     1.0 / math.sqrt(q.shape[-1]) if scale is None else scale)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[q.dtype], err
    assert torch.isfinite(lse).all()
    rows = slice(None) if kv_len is None else kv_len > 0  # a row with no key has no lse
    assert (lse[rows] - ref_lse[rows]).abs().max().item() <= LSE_TOL
    return out, lse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_serving_shape(cuda, dtype):
    _check(*_qkv(cuda, dtype, 2, 752, 752, 8, 96))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_training_shape(cuda, dtype):
    _check(*_qkv(cuda, dtype, 8, 768, 768, 8, 96))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 96, 128])
def test_ragged_varlen_scale(cuda, dtype, D):
    q, k, v = _qkv(cuda, dtype, 3, 100, 203, 2, D)
    kv_len = torch.tensor([203, 0, 77], dtype=torch.int32, device=cuda)
    out, lse = _check(q, k, v, kv_len, scale=0.3)
    assert (out[1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_strided_views_and_lse(cuda, dtype):
    # q/k/v as views into one packed [B, T, 3, H, D] tensor, as a fused projection gives
    B, T, H, D = 2, 130, 4, 96
    qkv = torch.randn(B, T, 3, H, D, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)
    _, lse = _check(q, k, v)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / D ** 0.5
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Tq,Tk", [(1, 1), (1, 129), (63, 65), (65, 63), (129, 1), (129, 257)])
def test_lengths_off_the_tile_grid(cuda, dtype, Tq, Tk):
    """Tq and Tk of 1, just under and just over a 32- or 64-key tile, and
    just over the 128-row query tile: the zero-filled rows of the last tiles
    add nothing, and rows past Tq are not written."""
    _check(*_qkv(cuda, dtype, 2, Tq, Tk, 2, 96, seed=Tq + Tk))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_len_cuts_inside_a_tile(cuda, dtype):
    q, k, v = _qkv(cuda, dtype, 6, 70, 200, 2, 64)
    lens = [1, 31, 33, 100, 129, 200]  # inside the first 32-key tile, and later ones
    out, _ = _check(q, k, v, torch.tensor(lens, dtype=torch.int32, device=cuda))
    for b, n in enumerate(lens):  # each row sees exactly its first n keys
        ref = fa.flash_attention_reference(q[b:b + 1, :, :, :], k[b:b + 1, :n], v[b:b + 1, :n])
        assert (out[b:b + 1].float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fwd_is_bit_equal_over_two_runs(cuda, dtype):
    q, k, v = _qkv(cuda, dtype, 8, 768, 768, 8, 96)
    kv_len = torch.tensor([768, 700, 1, 333, 768, 0, 65, 767], dtype=torch.int32, device=cuda)
    first = _check(q, k, v, kv_len)
    second = _check(q, k, v, kv_len)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert (first[0][5] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fwd_rows_off_16_byte_boundaries_are_copied(cuda, dtype):
    """q/k/v whose rows start one element off a 16-byte boundary, or whose
    row stride is not a multiple of 16 bytes, give bit for bit what their
    aligned copies give: the wrapper copies them for the kernel's 16-byte
    loads, as the JAX kernel takes any layout."""
    B, T, H, D = 2, 70, 2, 64
    aligned = _qkv(cuda, dtype, B, T, T, H, D)
    shifted, padded = [], []
    for t in aligned:
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        buf[1:] = t.flatten()
        shifted.append(buf[1:].view(B, T, H, D))
        assert shifted[-1].data_ptr() % 16 != 0
        buf = torch.zeros(B, T, H, D + 1, dtype=dtype, device=cuda)
        buf[..., :D] = t
        padded.append(buf[..., :D])
    want = fa.flash_attention_fwd(*aligned)
    for q, k, v in (shifted, padded):
        n = fa.LAUNCHES
        got = fa.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        assert fa.LAUNCHES == n + 1  # the kernel, not a plain fallback
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_rejects_unsupported_inputs(cuda):
    q = torch.zeros(1, 8, 1, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    h = torch.zeros(1, 8, 1, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(h, h, h)


def _bwd_check(q, k, v, kv_len=None, scale=None, dout=None, joint_scale=False):
    """K2/K3 against the plain backward on the same inputs; returns (dq, dk, dv).
    Each gradient is held to its own largest plain value, or with
    ``joint_scale`` to the largest of the three."""
    out, lse = fa.flash_attention_fwd(q, k, v, kv_len, scale)
    if dout is None:
        dout = torch.randn(out.shape, generator=torch.Generator(out.device).manual_seed(3),
                           device=out.device).to(out.dtype)
    n_dq, n_dkv = fa.LAUNCHES_DQ, fa.LAUNCHES_DKV
    got = fa.flash_attention_bwd(q, k, v, kv_len, out, lse, dout, scale)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_DQ, fa.LAUNCHES_DKV) == (n_dq + 1, n_dkv + 1)
    ref = fa.flash_attention_bwd_reference(q, k, v, kv_len, out, lse, dout, scale)
    largest = max(b.float().abs().max().item() for b in ref)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == q.dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        big = largest if joint_scale else b.float().abs().max().item()
        assert big > 0 and err <= BWD_TOL[q.dtype] * big, (name, err, big)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 768, 8, 96), (2, 752, 8, 96)])
def test_bwd_training_and_serving_shapes(cuda, dtype, shape):
    B, T, H, D = shape
    _bwd_check(*_qkv(cuda, dtype, B, T, T, H, D))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 96, 128])
def test_bwd_ragged_varlen_zero_row_scale(cuda, dtype, D):
    q, k, v = _qkv(cuda, dtype, 3, 100, 203, 2, D)
    kv_len = torch.tensor([203, 0, 77], dtype=torch.int32, device=cuda)
    dq, dk, dv = _bwd_check(q, k, v, kv_len, scale=0.3)
    assert (dq[1] == 0).all() and (dk[1] == 0).all() and (dv[1] == 0).all()
    assert (dk[2, 77:] == 0).all() and (dv[2, 77:] == 0).all()


def test_bwd_strided_inputs_and_noncontiguous_dout(cuda):
    B, T, H, D = 2, 130, 4, 96
    q, k, v = torch.randn(B, T, 3, H, D, device=cuda).unbind(2)
    dout = torch.randn(B, H, T, D, device=cuda).transpose(1, 2)  # [B, T, H, D] view
    _bwd_check(q, k, v, dout=dout)
    _bwd_check(q, k, v, dout=dout.transpose(2, 3).contiguous().transpose(2, 3))  # D strided


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,Tk", [(1, 1), (1, 129), (63, 65), (65, 63), (129, 1), (129, 257)])
def test_bwd_lengths_off_the_tile_grid(cuda, dtype, Tq, Tk):
    """Tq and Tk of 1, just under and just over a 64-row tile, and just over
    the 128-row owned tile: the zero-filled rows of the last tile add nothing.
    With a single key P is 1 and dS = dP - delta cancels to rounding noise, so
    dq and dk are 0 in exact arithmetic: they are held to dv's scale there."""
    _bwd_check(*_qkv(cuda, dtype, 2, Tq, Tk, 2, 96, seed=Tq + Tk), joint_scale=Tk == 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kv_len_cuts_inside_a_tile(cuda, dtype):
    q, k, v = _qkv(cuda, dtype, 5, 70, 200, 2, 64)
    lens = [1, 31, 33, 100, 129]  # inside the first 32- and 64-key tiles, and later ones
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    _, dk, dv = _bwd_check(q, k, v, kv_len)
    for b, n in enumerate(lens):
        assert (dk[b, n:] == 0).all() and (dv[b, n:] == 0).all()
        assert (dk[b, :n] != 0).any() and (dv[b, :n] != 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_rows_off_16_byte_boundaries_are_copied(cuda, dtype):
    """Inputs whose rows start one element off a 16-byte boundary, or whose
    row stride is not a multiple of 16 bytes, give bit for bit what their
    aligned copies give: the wrapper copies them, the kernels' 16-byte loads
    never see them."""
    B, T, H, D = 2, 70, 2, 64
    aligned = _qkv(cuda, dtype, B, T, T, H, D) + _qkv(cuda, dtype, B, T, T, H, D, seed=9)[:1]
    shifted = []
    for t in aligned:  # the same values, starting one element into a buffer
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        buf[1:] = t.flatten()
        shifted.append(buf[1:].view(B, T, H, D))
        assert shifted[-1].data_ptr() % 16 != 0
    padded = []
    for t in aligned:  # the same values, as [..., :D] of rows of D + 1
        buf = torch.zeros(B, T, H, D + 1, dtype=dtype, device=cuda)
        buf[..., :D] = t
        padded.append(buf[..., :D])
    out, lse = fa.flash_attention_fwd(*aligned[:3])
    want = fa.flash_attention_bwd(*aligned[:3], None, out, lse, aligned[3])
    for q, k, v, dout in (shifted, padded):
        n = (fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
        got = fa.flash_attention_bwd(q, k, v, None, out, lse, dout)
        torch.cuda.synchronize()
        assert (fa.LAUNCHES_DQ, fa.LAUNCHES_DKV) == (n[0] + 1, n[1] + 1)  # no plain fallback
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_is_bit_equal_over_two_runs(cuda, dtype):
    q, k, v = _qkv(cuda, dtype, 8, 768, 768, 8, 96)
    kv_len = torch.tensor([768, 700, 1, 333, 768, 64, 65, 767], dtype=torch.int32, device=cuda)
    first = _bwd_check(q, k, v, kv_len)
    second = _bwd_check(q, k, v, kv_len)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_goes_through_the_kernels(cuda, dtype):
    q, k, v = (t.requires_grad_() for t in _qkv(cuda, dtype, 2, 200, 200, 4, 64))
    kv_len = torch.tensor([200, 150], dtype=torch.int32, device=cuda)
    counts = (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
    out = fa.flash_attention(q, k, v, kv_len)
    assert out.grad_fn is not None
    dout = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV) == tuple(c + 1 for c in counts)
    o, lse = fa.flash_attention_fwd(q.detach(), k.detach(), v.detach(), kv_len)
    ref = fa.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(), kv_len, o, lse,
                                           dout)
    for a, b in zip(grads, ref):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * b.float().abs().max().item(), err


def test_bwd_rejects_unsupported_inputs(cuda):
    q = torch.zeros(1, 8, 1, 48, device=cuda)
    lse = torch.zeros(1, 1, 8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd(q, q, q, None, q, lse, q)
    q = torch.zeros(1, 8, 1, 64, device=cuda)
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention_bwd(q, q, q, None, q, lse, q.cpu())
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_bwd(q, q, q, None, q, lse, q[:, :4])


def test_each_backward_wrapper_counts_its_own_kernel(cuda):
    q, k, v, dout = _qkv(cuda, torch.float32, 1, 70, 70, 2, 64) + [None]
    out, lse = fa.flash_attention_fwd(q, k, v)
    dout = torch.randn_like(out)
    delta = fa._delta(out, dout)
    n = (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
    fa.flash_attention_bwd_dq(q, k, v, None, lse, delta, dout, 0.125)
    assert (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV) == (n[0], n[1] + 1, n[2])
    fa.flash_attention_bwd_dkv(q, k, v, None, lse, delta, dout, 0.125)
    assert (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV) == (n[0], n[1] + 1, n[2] + 1)


def test_dit_training_step_goes_through_k1_k2_k3(cuda):
    """A small BandMoeDiT (head dim 32) in training mode on the card: one K1,
    K2 and K3 launch per block, and the gradients of the CPU's plain path
    (fp32, each parameter within 2e-3 of its own largest gradient, or of 1e-3
    x the largest of all where its own is smaller: summation order through 2
    blocks, and the embedding tables' backward sums its rows in another order
    on the card, 7.1e-4 of its own scale on ``midi_embedding`` on an H100);
    every self-attention projection gets a nonzero gradient."""
    import copy

    from versband_tpu_torch.models.dit import BandMoeDiT

    torch.manual_seed(0)
    cpu = BandMoeDiT(in_channels=4, context_dim=64, hidden_size=64, depth=2, num_heads=2,
                     max_len=128, num_experts=2, ori_dim=12, multiple_of=8, use_flash=True)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "adaLN" in name or "final_layer" in name or name.endswith("gate"):
                p.normal_(0, 0.2)
    gpu = copy.deepcopy(cpu).to(cuda)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 4, 40).astype(np.float32))
    t = torch.tensor([10.0, 900.0])
    ctx = {"c_concat": {"midi": torch.from_numpy(rng.randint(0, 130, (2, 1, 80))),
                        "beats": torch.from_numpy(rng.randint(0, 3, (2, 1, 80)))},
           "c_crossattn": torch.from_numpy(rng.randn(2, 5, 12).astype(np.float32))}
    noise = [torch.from_numpy(rng.gumbel(size=s).astype(np.float32))
             for s in cpu.gumbel_shapes(2, 40)]
    n = (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
    for model, dev in ((gpu, cuda), (cpu, torch.device("cpu"))):
        c = {"c_concat": {k: v.to(dev) for k, v in ctx["c_concat"].items()},
             "c_crossattn": ctx["c_crossattn"].to(dev)}
        out, lb = model(x.to(dev), t.to(dev), c, train=True,
                        gumbel=iter(g.to(dev) for g in noise))
        (out.square().mean() + lb).backward()
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV) == tuple(c + 2 for c in n)
    big = max(p.grad.abs().max().item() for p in cpu.parameters())
    for (name, a), b in zip(gpu.named_parameters(), cpu.parameters()):
        own = b.grad.abs().max().item()
        assert (a.grad.cpu() - b.grad).abs().max().item() <= 2e-3 * max(own, 1e-3 * big), name
    for layer in gpu.layers:
        for w in (layer.attention.wq, layer.attention.wk, layer.attention.wv):
            assert w.weight.grad.abs().max() > 0


def _k4_check(x, alpha, beta, logscale):
    n = fa1.LAUNCHES
    out = fa1.fused_alias_free_snake(x, alpha, beta, logscale)
    torch.cuda.synchronize()
    assert fa1.LAUNCHES == n + 1 and out.dtype == x.dtype and out.shape == x.shape
    ref = fa1.alias_free_snake_reference(x, alpha, beta, logscale)
    big = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(1.0, big) if x.dtype == torch.float32 else big
    assert torch.isfinite(out).all() and err <= K4_TOL[x.dtype] * scale, (err, big)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,T", [(1, 32, 5000), (2, 16, 1), (2, 16, 5), (1, 8, 37),
                                   (2, 4, 2049)])
def test_k4_against_plain(cuda, dtype, B, C, T):
    g = torch.Generator(cuda).manual_seed(T)
    x = torch.randn(B, C, T, generator=g, device=cuda).to(dtype)
    alpha, beta = (torch.randn(C, generator=g, device=cuda) * 0.3 for _ in range(2))
    _k4_check(x, alpha, beta, True)


@pytest.mark.parametrize("variant", ["snake", "snakebeta"])
@pytest.mark.parametrize("logscale", [True, False])
def test_k4_variants_and_strided_input(cuda, variant, logscale):
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(2, 1500, 6, generator=g, device=cuda).transpose(1, 2)  # [B, C, T] view
    alpha = torch.rand(6, generator=g, device=cuda) + 0.2
    beta = torch.rand(6, generator=g, device=cuda) + 0.2 if variant == "snakebeta" else None
    _k4_check(x, alpha, beta, logscale)


def _k5_layer(cuda, R, G2, S, A, d, seed):
    from versband_tpu_torch.vocoder.pwg import ResidualBlock

    torch.manual_seed(seed)
    blk = ResidualBlock(3, R, G2, S, A, d).to(cuda)
    return (blk.conv.weight, blk.conv.bias, blk.conv1x1_aux.weight, blk.conv1x1_skip.weight,
            blk.conv1x1_skip.bias, blk.conv1x1_out.weight, blk.conv1x1_out.bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", [(64, 128, 64, 80), (8, 16, 6, 5)])
@pytest.mark.parametrize("B,T,d", [(2, 1000, 1), (2, 333, 7), (1, 50, 64), (1, 2048, 512)])
def test_k5_against_plain(cuda, dtype, widths, B, T, d):
    R, G2, S, A = widths
    w = _k5_layer(cuda, R, G2, S, A, d, T + d)
    g = torch.Generator(cuda).manual_seed(d)
    x = torch.randn(B, R, T, generator=g, device=cuda).to(dtype)
    c = torch.randn(B, A, T, generator=g, device=cuda).to(dtype)
    skip = torch.randn(B, S, T, generator=g, device=cuda)
    n = fw.LAUNCHES
    with torch.no_grad():
        xo, so = fw.fused_wavenet_layer(x, c, skip, *w, d, fw.PackCache())
        torch.cuda.synchronize()
        assert fw.LAUNCHES == n + 1 and xo.dtype == dtype and so.dtype == torch.float32
        rx, rs = fw.wavenet_layer_reference(x, c, skip, *w, d)
    for got, ref, tol in zip((xo, so), (rx, rs), K5_TOL[dtype]):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol * ref.float().abs().max().item(), err


def test_k5_pack_cache_sees_weight_changes(cuda):
    """A ResidualBlock packs K5's weights once and keeps them; after an
    in-place update, a load_state_dict and a move of its weights the next
    call must use the new weights (against the plain version of each)."""
    from versband_tpu_torch.vocoder.pwg import ResidualBlock

    torch.manual_seed(3)
    blk = ResidualBlock(3, 64, 128, 64, 80, 2).to(cuda)
    g = torch.Generator(cuda).manual_seed(3)
    x = torch.randn(1, 64, 1000, generator=g, device=cuda)
    c = torch.randn(1, 80, 1000, generator=g, device=cuda)
    skip = torch.randn(1, 64, 1000, generator=g, device=cuda)

    def check():
        with torch.no_grad():
            got = blk(x, c, skip)
            w = (blk.conv.weight, blk.conv.bias, blk.conv1x1_aux.weight,
                 blk.conv1x1_skip.weight, blk.conv1x1_skip.bias, blk.conv1x1_out.weight,
                 blk.conv1x1_out.bias)
            ref = fw.wavenet_layer_reference(x, c, skip, *w, 2)
        torch.cuda.synchronize()
        for a, r, tol in zip(got, ref, K5_TOL[torch.float32]):
            assert (a - r).abs().max().item() <= tol * r.abs().max().item()
        return got

    n = fw.LAUNCHES
    first = check()
    packed = blk._k5_pack.packed
    check()
    assert blk._k5_pack.packed is packed  # unchanged weights: no repack
    with torch.no_grad():
        blk.conv1x1_aux.weight.mul_(-1.5)
    assert not torch.equal(check()[1], first[1])
    torch.manual_seed(4)
    blk.load_state_dict(ResidualBlock(3, 64, 128, 64, 80, 2).state_dict())
    check()
    blk.to("cpu").to(cuda)
    check()
    assert fw.LAUNCHES == n + 5


def test_wrappers_raise_and_do_not_fall_back(cuda):
    """float16 is taken by neither kernel: a TypeError, no plain-version answer."""
    x = torch.zeros(1, 4, 16, device=cuda, dtype=torch.float16)
    n = fa1.LAUNCHES
    with pytest.raises(TypeError):
        fa1.fused_alias_free_snake(x, torch.zeros(4, device=cuda))
    assert fa1.LAUNCHES == n
    w = _k5_layer(cuda, 4, 8, 4, 3, 1, 0)
    c = torch.zeros(1, 3, 16, device=cuda, dtype=torch.float16)
    skip = torch.zeros(1, 4, 16, device=cuda)
    n = fw.LAUNCHES
    with pytest.raises(TypeError):
        fw.fused_wavenet_layer(x, c, skip, *w, 1, fw.PackCache())
    with pytest.raises(ValueError, match="G, S, R"):
        fw.fused_wavenet_layer(torch.zeros(1, 4, 16, device=cuda),
                               torch.zeros(1, 3, 16, device=cuda), skip,
                               *_k5_layer(cuda, 4, 160, 4, 3, 1, 0), 1, fw.PackCache())
    with pytest.raises(ValueError, match="3R \\+ A"):  # 3 x 64 + 100 > 288
        fw.fused_wavenet_layer(torch.zeros(1, 64, 16, device=cuda),
                               torch.zeros(1, 100, 16, device=cuda),
                               torch.zeros(1, 4, 16, device=cuda),
                               *_k5_layer(cuda, 64, 8, 4, 100, 1, 0), 1, fw.PackCache())
    assert fw.LAUNCHES == n


def test_vocoder_forwards_launch_k4_and_k5(cuda):
    """One BigVGAN forward (2 stages x 2 AMP blocks x 3 dilations x 2
    activations + activation_post = 25 K4) and one PWG forward (6 layers = 6
    K5) at small widths, against the same modules on the CPU."""
    import copy

    from versband_tpu_torch.vocoder.bigvgan import BigVGANGenerator
    from versband_tpu_torch.vocoder.pwg import ParallelWaveGANGenerator

    torch.manual_seed(0)
    big = BigVGANGenerator(num_mels=80, upsample_initial_channel=32, upsample_rates=(4, 4),
                           upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 7),
                           resblock_dilation_sizes=((1, 3, 5),) * 2).eval()
    pwg = ParallelWaveGANGenerator(layers=6, stacks=3, residual_channels=16, gate_channels=32,
                                   skip_channels=16, aux_channels=80, upsample_scales=(4, 4),
                                   fused_inference=True).eval()
    rng = np.random.RandomState(0)
    mel = torch.from_numpy(rng.randn(1, 80, 24).astype(np.float32))
    noise = torch.from_numpy(rng.randn(1, 1, 20 * 16).astype(np.float32))
    with torch.no_grad():
        for model, args, counter, want in ((big, (mel,), fa1, 25), (pwg, (noise, mel), fw, 6)):
            n = counter.LAUNCHES
            out = copy.deepcopy(model).to(cuda)(*(a.to(cuda) for a in args))
            torch.cuda.synchronize()
            assert counter.LAUNCHES - n == want
            ref = model(*args)
            assert (out.cpu() - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


# a tiny copy of configs/vocal2music.yaml (the card's machine has no PyYAML
# to write one from the shipped file); head dim 32, one K1 supports
TINY_CLI_YAML = """\
model:
  target: versband_tpu.models.cfm.CFM
  params:
    mel_dim: 4
    scale_by_std: true
    unet_config:
      target: versband_tpu.models.dit.BandMoeDiT
      params: {in_channels: 4, ori_dim: 32, context_dim: 16, hidden_size: 64, num_heads: 2,
               depth: 2, max_len: 64, num_experts: 2, multiple_of: 8, use_flash: true}
    first_stage_config:
      target: versband_tpu.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        ckpt_path: logs/ae_accomp/checkpoints/last
        ddconfig: {double_z: true, in_channels: 80, out_ch: 80, z_channels: 4, kernel_size: 5,
                   ch: 8, ch_mult: [1, 2], num_res_blocks: 1, attn_layers: [],
                   down_layers: [0], dropout: 0.0}
        lossconfig: {target: versband_tpu.utils.config.Identity}
    cond_stage_config:
      target: versband_tpu.text.embedders.TextVocalEmbedder
      params: {version: useful_ckpts/flan-t5-large, max_length: 24}
data:
  params: {main_spec_dir_path: none, other_condition: none}
"""
TINY_T5 = dict(model_type="t5", d_model=32, d_ff=48, d_kv=8, num_heads=4, num_layers=2,
               feed_forward_proj="gated-gelu", vocab_size=32128)
TINY_DIT = dict(in_channels=4, ori_dim=32, context_dim=16, hidden_size=64, num_heads=2,
                depth=2, max_len=64, num_experts=2, multiple_of=8, use_flash=True)
TINY_VAE = dict(embed_dim=4, ddconfig=dict(double_z=True, in_channels=80, out_ch=80,
                                           z_channels=4, kernel_size=5, ch=8, ch_mult=[1, 2],
                                           num_res_blocks=1, attn_layers=[], down_layers=[0],
                                           dropout=0.0))


def test_t5_tower_on_the_card_matches_the_cpu(cuda, tmp_path):
    import chip_smoke
    from versband_tpu_torch.text.embedders import TextVocalEmbedder

    chip_smoke.write_t5_dir(tmp_path / "t5", TINY_T5, seed=0)
    texts = ["Style: soft piano Musical: This melody, set in C major, moves slowly.", ""]
    cpu = TextVocalEmbedder(version=str(tmp_path / "t5"), max_length=24, device="cpu")
    gpu = TextVocalEmbedder(version=str(tmp_path / "t5"), max_length=24, device=cuda)
    with torch.no_grad():
        ref = cpu({"caption": texts, "acoustic": {}})["caption"]
        out = gpu({"caption": texts, "acoustic": {}})["caption"]
    assert out.device.type == "cuda" and out.shape == (2, 24, 32)
    assert (out.cpu() - ref).abs().max().item() <= 1e-5


def test_cli_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """One item at --scales 1-2 through ``cli.generate.main``, on the card and
    with --platform cpu, from the same checkpoints and start noise."""
    import chip_smoke
    from scipy.io import wavfile

    from versband_tpu_torch.cli import generate as cli

    chip_smoke.write_t5_dir(tmp_path / "useful_ckpts" / "flan-t5-large", TINY_T5, seed=0)
    inputs = chip_smoke.write_cli_inputs(tmp_path, 1, 37, TINY_DIT, TINY_VAE, seed=0)
    (tmp_path / "tiny.yaml").write_text(TINY_CLI_YAML)
    monkeypatch.chdir(tmp_path)
    argv = ["--config", "tiny.yaml", "--ckpt", inputs["dit"], "--vae_ckpt", inputs["vae"],
            "--vocoder_ckpt", inputs["vocoder"], "--manifest", inputs["manifest"],
            "--other_condition", inputs["midi"], "--scales", "1-2", "--num_items", "1"]
    runs = {}
    for name, extra in (("cpu", ["--platform", "cpu"]), ("card", [])):
        rng = np.random.RandomState(3)
        monkeypatch.setattr(cli, "start_noise", lambda gen, shape, device: torch.from_numpy(
            rng.standard_normal(tuple(shape)).astype(np.float32)).to(device))
        n = fa.LAUNCHES
        assert cli.main(argv + ["--save_dir", name] + extra) == 0
        runs[name] = fa.LAUNCHES - n
    assert runs == {"cpu": 0, "card": 24 * TINY_DIT["depth"] * 2}
    for scale in ("1.0", "2.0"):
        rel = f"cond_gtcodec_accomp_scale_{scale}/0-0000[0][accomp].wav"
        want = wavfile.read(tmp_path / "cpu" / rel)[1].astype(np.int32)
        got = wavfile.read(tmp_path / "card" / rel)[1].astype(np.int32)
        assert got.shape == want.shape == (40 * 320,)
        assert np.abs(got - want).max() <= 1e-3 * 32767
    csv_cpu = (tmp_path / "cpu" / "clap.csv").read_text().replace("cpu/", "")
    assert csv_cpu == (tmp_path / "card" / "clap.csv").read_text().replace("card/", "")


def test_cli_train_on_the_card(cuda, tmp_path, monkeypatch):
    """Two steps of ``cli.train`` (one group of 2) on ``configs/vocal2music.yaml``
    shrunk by overrides, then validation over the 300 held-out rows: K1 in
    every forward, K2 and K3 in every backward, the caption tower (the
    random fallback at a tiny width) on the card."""
    from pathlib import Path

    import chip_smoke
    from versband_tpu_torch.cli import train as cli

    config = Path(__file__).resolve().parents[1] / "configs" / "vocal2music.yaml"
    manifest, midi = chip_smoke.write_train_manifest(tmp_path / "data", 308, 2, 70, seed=0)
    monkeypatch.chdir(tmp_path)
    over = [f"data.params.main_spec_dir_path={manifest}", f"data.params.other_condition={midi}",
            "data.params.batch_size=4", "data.params.spec_crop_len=64",
            "data.params.min_batch_len=64", "model.params.mel_dim=4",
            *(f"model.params.unet_config.params.{k}={v}" for k, v in TINY_DIT.items()
              if k != "use_flash"),
            *(f"model.params.first_stage_config.params.{o}" for o in (
                "embed_dim=4", "ddconfig.z_channels=4", "ddconfig.ch=8",
                "ddconfig.ch_mult=[1, 2]", "ddconfig.num_res_blocks=1",
                "ddconfig.attn_layers=[]")),
            "model.params.cond_stage_config.params.max_length=16",
            "model.params.cond_stage_config.params.fallback_config={d_model: 32, d_ff: 48, "
            "d_kv: 8, num_heads: 4, num_layers: 2}"]
    n0 = (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
    run = {}
    assert cli.main(["-b", str(config), "-t", "--no-test", "-l", "logs", "--max_steps", "2",
                     "--max_epochs", "1", "--steps_per_call", "2", *over], run=run) == 0
    torch.cuda.synchronize()
    n = tuple(b - a for a, b in zip(n0, (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)))
    depth, val_batches = TINY_DIT["depth"], 300 // 4
    assert n == (depth * (2 + val_batches), depth * 2, depth * 2)
    tr = run["trainer"]
    assert tr.global_step == 2 and tr.device.type == "cuda"
    assert tr._encode_caption_list(["a", "b", "a"]).device.type == "cuda"
    meta = (Path(run["logdir"]) / "checkpoints" / "last_step.json").read_text()
    assert '"step": 2' in meta


def test_vae_gan_step_on_the_card_matches_the_cpu(cuda):
    from versband_tpu_torch.models.autoencoder import AutoencoderKL
    from versband_tpu_torch.train.gan_losses import VAEGANLoss
    from versband_tpu_torch.train.state import TrainState, make_adam
    from versband_tpu_torch.train.vae_step import make_vae_train_step

    dd = dict(double_z=True, in_channels=80, out_ch=80, z_channels=4, kernel_size=5, ch=32,
              ch_mult=[1, 2], num_res_blocks=1, attn_layers=[], down_layers=[0], dropout=0.0)
    rng = np.random.RandomState(0)
    mel = torch.from_numpy(rng.randn(2, 80, 64).astype(np.float32))
    noise = torch.from_numpy(rng.randn(2, 4, 32).astype(np.float32))
    runs = []
    for device in ("cuda", "cpu"):
        torch.manual_seed(0)
        vae = AutoencoderKL(embed_dim=4, ddconfig=dd).to(device)
        loss = VAEGANLoss(disc_start=0, disc_hidden_size=16, disc_num_layers=2).to(device)
        gen, disc = TrainState(vae, make_adam(1e-3)), TrainState(loss, make_adam(1e-3))
        grads = {}
        for name, state in (("gen", gen), ("disc", disc)):
            def snap(state=state, name=name, apply=state.apply_gradients):
                grads.update({f"{name}.{k}": p.grad.float().cpu() for k, p in state.named.items()
                              if p.grad is not None})
                return apply()
            state.apply_gradients = snap
        n0 = (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV, fa1.LAUNCHES)
        with torch.backends.cudnn.flags(allow_tf32=False):
            m = make_vae_train_step(vae, loss)(gen, disc, {"image": mel.to(device)},
                                               given={"posterior": noise.to(device)})
        assert (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV, fa1.LAUNCHES) == n0
        runs.append(({k: float(v) for k, v in m.items()}, grads))
    (m_gpu, g_gpu), (m_cpu, g_cpu) = runs
    for k in ("aeloss", "discloss", "d_weight", "r1_penalty"):
        assert abs(m_gpu[k] - m_cpu[k]) <= 1e-5 * abs(m_cpu[k]), (k, m_gpu[k], m_cpu[k])
    assert set(g_gpu) == set(g_cpu) and "disc.discriminator.main.3.running_mean" in g_cpu
    big = max(g.abs().max() for g in g_cpu.values())
    for k, g in g_cpu.items():  # a gradient that is 0 but for rounding: the floor
        assert (g_gpu[k] - g).abs().max() <= 1e-4 * max(g.abs().max(), 1e-3 * big), k


def test_vocoder_recipe_steps_on_the_card_match_the_cpu(cuda):
    """One HiFi-GAN-recipe step (trainable HiFi-GAN, MPD, MRD, mel L1 on the
    device) and one PWG-recipe step (gate open) at tiny widths, card against
    CPU: no kernel launched (training is unfused), losses 1e-5 relative,
    gradients 1e-3 of their parameter's largest (floored as above), the bar
    of ``torch_port_helpers.assert_grads_match``: the tiny generators'
    near-silent output puts the log magnitudes near their clamps (1e-7
    power, 1e-5 mel), where the gradient is the reciprocal of a value held
    to fp32's rounding (measured 3.6e-4 on the PWG upsampler's conv)."""
    from versband_tpu_torch.dsp.mel import MelConfig, MelSpectrogram
    from versband_tpu_torch.train.state import TrainState, make_adamw, make_radam
    from versband_tpu_torch.train.vocoder_step import make_hifigan_train_step, make_pwg_train_step
    from versband_tpu_torch.vocoder.discriminators import (MultiPeriodDiscriminator,
                                                          MultiResolutionDiscriminator)
    from versband_tpu_torch.vocoder.hifigan import HifiGanGenerator
    from versband_tpu_torch.vocoder.pwg import (ParallelWaveGANDiscriminator,
                                                ParallelWaveGANGenerator)

    rng = np.random.RandomState(0)
    mel_fn = MelSpectrogram(MelConfig(n_mels=16, n_fft=128, win_size=128, hop_size=16))
    wav = torch.from_numpy((rng.randn(2, 1120) * 0.3).astype(np.float32))
    mel = torch.from_numpy(rng.randn(2, 20, 74).astype(np.float32))
    noise = torch.from_numpy(rng.randn(2, 1, 1120).astype(np.float32))
    gen_kw = dict(upsample_initial_channel=16, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                  resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),))
    pwg_kw = dict(layers=6, stacks=3, residual_channels=8, gate_channels=16, skip_channels=8,
                  aux_channels=20, upsample_scales=(4, 4))
    for recipe in ("hifigan", "pwg"):
        runs = []
        for device in ("cuda", "cpu"):
            torch.manual_seed(1)
            if recipe == "hifigan":
                gen = HifiGanGenerator(in_channels=20, **gen_kw, use_weight_norm=True)
                disc = torch.nn.ModuleDict({
                    "mpd": MultiPeriodDiscriminator((2, 3)),
                    "mrd": MultiResolutionDiscriminator(((64, 16, 32), (128, 32, 64)), 0.25)})
                gen, disc = gen.to(device), disc.to(device)
                states = TrainState(gen, make_adamw(1e-4)), TrainState(disc, make_adamw(1e-4))
                step = make_hifigan_train_step(gen, disc["mpd"], disc["mrd"], mel_fn)
                batch = {"mel": mel[..., :70], "wav": wav}
            else:
                gen = ParallelWaveGANGenerator(**pwg_kw, use_weight_norm=True).to(device)
                disc = ParallelWaveGANDiscriminator(layers=4, conv_channels=8).to(device)
                states = TrainState(gen, make_radam(1e-4)), TrainState(disc, make_radam(5e-5))
                step = make_pwg_train_step(gen, disc, disc_start=0)
                batch = {"mel": mel, "wav": wav[:, :1120], "noise": noise}
            grads = {}
            for name, state in zip(("gen", "disc"), states):
                def snap(state=state, name=name, apply=state.apply_gradients):
                    grads.update({f"{name}.{k}": p.grad.float().cpu()
                                  for k, p in state.named.items()})
                    return apply()
                state.apply_gradients = snap
            n0 = (fa1.LAUNCHES, fw.LAUNCHES)
            m = step(*states, {k: v.to(device) for k, v in batch.items()})
            assert (fa1.LAUNCHES, fw.LAUNCHES) == n0
            runs.append(({k: float(v) for k, v in m.items()}, grads))
        (m_gpu, g_gpu), (m_cpu, g_cpu) = runs
        for k in m_cpu:
            assert abs(m_gpu[k] - m_cpu[k]) <= 1e-5 * abs(m_cpu[k]), (recipe, k)
        big = max(g.abs().max() for g in g_cpu.values())
        for k, g in g_cpu.items():
            assert (g_gpu[k] - g).abs().max() <= 1e-3 * max(g.abs().max(), 1e-3 * big), k


def test_nsf_serves_on_the_card(cuda):
    """``build_vocoder("nsf")`` on the card: f0 estimated on the host, the
    draws from the wrapper's generator on the card; the same waveform as the
    same model on the CPU given the card's draws."""
    from versband_tpu_torch.cli.generate import build_vocoder
    from versband_tpu_torch.vocoder.nsf import estimate_f0_from_mel

    kw = dict(upsample_initial_channel=32, upsample_rates=(5, 4, 4, 4),
              upsample_kernel_sizes=(9, 8, 8, 8))
    voc = build_vocoder("nsf", device="cuda")
    assert voc.device.type == "cuda"
    from versband_tpu_torch.vocoder.nsf import HifiGAN_NSF

    voc = HifiGAN_NSF(device="cuda", **kw)
    mel = (np.random.RandomState(2).randn(80, 40) - 2.0).astype(np.float32)
    mel[12] += 3.0
    wav = voc(mel)
    assert wav.shape == (40 * 320,) and np.isfinite(wav).all()
    g = torch.Generator(device="cuda").manual_seed(0)  # the wrapper's first draws
    phase = torch.rand((1, 1, 9), generator=g, device="cuda").cpu()
    noise = torch.randn((1, 40 * 320, 9), generator=g, device="cuda").cpu()
    cpu = HifiGAN_NSF(device="cpu", **kw)
    f0 = torch.from_numpy(estimate_f0_from_mel(mel))[None]
    with torch.no_grad():
        ref = cpu.model(torch.from_numpy(mel)[None], f0, init_phase=phase, noise=noise)
    assert np.abs(wav - ref[0].numpy()).max() <= 1e-4 * max(1.0, np.abs(wav).max())


def _small_dit(cuda):
    import copy

    from versband_tpu_torch.models.dit import BandMoeDiT

    torch.manual_seed(0)
    cpu = BandMoeDiT(in_channels=4, context_dim=64, hidden_size=64, depth=4, num_heads=2,
                     max_len=128, num_experts=2, ori_dim=12, multiple_of=8, use_flash=True).eval()
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "adaLN" in name or "final_layer" in name or name.endswith("gate"):
                p.normal_(0, 0.2)
    return cpu, copy.deepcopy(cpu).to(cuda)


def _dit_ctx(rng, B, t_mel, dev):
    return {"c_concat": {"midi": torch.from_numpy(rng.randint(0, 130, (B, 1, t_mel))).to(dev),
                         "beats": torch.from_numpy(rng.randint(0, 3, (B, 1, t_mel))).to(dev)},
            "c_crossattn": torch.from_numpy(rng.randn(B, 5, 12).astype(np.float32)).to(dev)}


@pytest.mark.parametrize("sampler", ["ddim", "plms"])
def test_samplers_over_a_dit_launch_k1_per_block_and_match_the_cpu(cuda, sampler):
    """DDIM (eta 1, CFG 2) and PLMS over 10 of 1000 timesteps: 4 K1 launches
    per model call (10 calls for DDIM, 11 for PLMS), the latents within 2e-3
    of the CPU's plain path from the same draws."""
    from versband_tpu_torch.models.samplers import DDIMSampler, PLMSSampler
    from versband_tpu_torch.models.schedules import DiffusionSchedule

    cpu, gpu = _small_dit(cuda)
    sched = DiffusionSchedule.create(1000, "linear", 0.00085, 0.012)
    rng = np.random.RandomState(2)
    shape = (2, 4, 40)
    x_T = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    draws = [torch.from_numpy(rng.randn(*shape).astype(np.float32)) for _ in range(10)]
    out = {}
    for model, dev in ((gpu, cuda), (cpu, torch.device("cpu"))):
        rng = np.random.RandomState(4)
        ctx, uctx = _dit_ctx(rng, 2, 80, dev), _dit_ctx(rng, 2, 80, dev)
        kw = dict(S=10, unconditional_guidance_scale=2.0, unconditional_conditioning=uctx,
                  x_T=x_T.to(dev))
        n = fa.LAUNCHES
        if sampler == "ddim":
            z = DDIMSampler(model, sched).sample(shape, ctx, eta=1.0,
                                                 noise=lambda i: draws[i].to(dev), **kw)
        else:
            z = PLMSSampler(model, sched).sample(shape, ctx, **kw)
        torch.cuda.synchronize()
        out[dev.type] = (z, fa.LAUNCHES - n)
    calls = 10 + (sampler == "plms")
    assert out["cuda"][1] == 4 * calls and out["cpu"][1] == 0
    z, ref = out["cuda"][0].cpu(), out["cpu"][0]
    assert torch.isfinite(z).all() and (z - x_T).abs().max() > 1e-2
    assert (z - ref).abs().max().item() <= 2e-3


def test_clap_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Cnn14 (BatchNorm statistics off their defaults) and the BERT tower
    read from a directory, card against CPU, fp32."""
    import chip_smoke
    from versband_tpu_torch.text.clap import CLAP

    bert = dict(chip_smoke.BERT_BASE_UNCASED, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=96)
    chip_smoke.write_bert_dir(tmp_path / "bert", bert, seed=0)
    kw = dict(d_proj=32, cnn_kwargs=dict(channels=(8, 16, 16, 32, 32, 64), out_emb=32),
              text_model=str(tmp_path / "bert"))
    cpu = CLAP(device="cpu", **kw)
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for name, b in cpu.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.3)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    gpu = CLAP(device=cuda, **kw)
    gpu.load_state_dict(cpu.state_dict())
    wav = np.random.RandomState(0).randn(2, 44100 * 2).astype(np.float32) * 0.1
    texts = ["Style: soft piano Musical: a calm melody", "loud drums"]
    a, t = cpu.get_audio_embeddings(wav), cpu.get_text_embeddings(texts)
    ga, gt = gpu.get_audio_embeddings(wav), gpu.get_text_embeddings(texts)
    assert ga.device.type == "cuda" and ga.shape == (2, 32) and gt.shape == (2, 32)
    sims = (gpu.compute_similarity(ga, gt), cpu.compute_similarity(a, t))
    for got, ref in ((ga, a), (gt, t), sims):
        assert (got.cpu() - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
