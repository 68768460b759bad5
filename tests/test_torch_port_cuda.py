"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode. This file imports neither JAX nor the JAX package, so
it runs on a machine with only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances against the plain version: fp32 1e-4 (summation order over up
to 752 keys); bf16 2e-2 (the probabilities and the output are rounded to
bf16; outputs are O(1)).
"""

import numpy as np
import pytest
import torch

from versband_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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
    ref = fa.flash_attention_reference(q, k, v, kv_len, scale)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[q.dtype], err
    assert torch.isfinite(lse).all()
    return out, lse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_serving_shape(cuda, dtype):
    _check(*_qkv(cuda, dtype, 2, 752, 752, 8, 96))


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
