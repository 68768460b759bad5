"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode. This file imports neither JAX nor the JAX package, so
it runs on a machine with only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances against the plain version: K1 fp32 1e-4 (summation order over up
to 768 keys); bf16 2e-2 (the probabilities and the output are rounded to
bf16; outputs are O(1)); K1's log-sum-exp 1e-4 absolute on rows with a key
(fp32 on both sides from the same widened inputs). K2/K3 are held to their
plain backward as max|kernel - plain| / max|plain|: fp32 1e-4 (summation
order over up to 768 rows or keys, same fp32 arithmetic); bf16 1e-2 (both
sides compute in fp32 from the same bf16 inputs and round each gradient to
bf16 once: half an ulp is 2^-9 of a value).
"""

import math

import numpy as np
import pytest
import torch

from versband_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
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
@pytest.mark.parametrize("D", [32, 64, 128])
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


def test_rejects_unsupported_inputs(cuda):
    q = torch.zeros(1, 8, 1, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    h = torch.zeros(1, 8, 1, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(h, h, h)


def _bwd_check(q, k, v, kv_len=None, scale=None, dout=None):
    """K2/K3 against the plain backward on the same inputs; returns (dq, dk, dv)."""
    out, lse = fa.flash_attention_fwd(q, k, v, kv_len, scale)
    if dout is None:
        dout = torch.randn(out.shape, generator=torch.Generator(out.device).manual_seed(3),
                           device=out.device).to(out.dtype)
    n_dq, n_dkv = fa.LAUNCHES_DQ, fa.LAUNCHES_DKV
    got = fa.flash_attention_bwd(q, k, v, kv_len, out, lse, dout, scale)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_DQ, fa.LAUNCHES_DKV) == (n_dq + 1, n_dkv + 1)
    ref = fa.flash_attention_bwd_reference(q, k, v, kv_len, out, lse, dout, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == q.dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        big = b.float().abs().max().item()
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
