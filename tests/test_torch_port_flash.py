"""K1 (flash-attention forward) in the port against the JAX package.

On the CPU the port's wrapper runs its plain version; the JAX side runs the
Pallas kernel in interpret mode, as tests/test_flash_attention.py does.
Tolerances: fp32 2e-5 (summation order); bf16 I/O 3e-2 (one bf16 rounding
of outputs O(1), and the two frameworks round at other places). The CUDA
kernel itself is held against the plain version in test_torch_port_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.ops import flash_attention as jax_flash
from versband_tpu.ops.flash_attention import _flash_fwd_impl
from versband_tpu_torch.ops import flash_attention as fa

FP32_TOL = 2e-5
BF16_TOL = 3e-2


def _qkv(seed, B, Tq, Tk, H, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Tq, H, D).astype(np.float32),
            rng.randn(B, Tk, H, D).astype(np.float32),
            rng.randn(B, Tk, H, D).astype(np.float32))


def _both(q, k, v, kv_len=None, scale=None):
    port = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              None if kv_len is None else torch.tensor(kv_len), scale)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    None if kv_len is None else jnp.asarray(kv_len, jnp.int32), scale)
    return port.numpy(), np.asarray(ref)


@pytest.mark.parametrize("Tq,Tk,D", [(40, 72, 64), (24, 56, 96)])
def test_unmasked_tq_ne_tk(Tq, Tk, D):
    port, ref = _both(*_qkv(0, 2, Tq, Tk, 2, D))
    np.testing.assert_allclose(port, ref, atol=FP32_TOL, rtol=FP32_TOL)


def test_varlen_mask():
    port, ref = _both(*_qkv(1, 3, 24, 72, 2, 96), kv_len=[72, 17, 40])
    np.testing.assert_allclose(port, ref, atol=FP32_TOL, rtol=FP32_TOL)


def test_kv_len_zero_row_and_lse():
    q, k, v = _qkv(2, 2, 16, 48, 2, 64)
    kv_len = np.array([0, 48], np.int32)
    out, lse = fa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), torch.from_numpy(kv_len))
    ref_out, ref_lse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(kv_len), 1.0 / math.sqrt(64), 16, 48, True)
    np.testing.assert_array_equal(out[0].numpy(), 0.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=FP32_TOL, rtol=FP32_TOL)
    ref_lse = np.asarray(ref_lse)[:, :, :16, 0]
    assert np.isfinite(lse.numpy()).all()
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=FP32_TOL, rtol=FP32_TOL)


def test_explicit_scale():
    port, ref = _both(*_qkv(3, 1, 32, 32, 1, 64), scale=0.5)
    np.testing.assert_allclose(port, ref, atol=FP32_TOL, rtol=FP32_TOL)


def test_bf16_io():
    q, k, v = _qkv(4, 2, 32, 32, 2, 64)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    port = fa.flash_attention(tq, tk, tv)
    assert port.dtype == torch.bfloat16
    ref = jax_flash(*(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (tq, tk, tv)))
    assert ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


def test_other_devices_and_bad_shapes_raise():
    before = fa.LAUNCHES
    q = torch.zeros(1, 8, 1, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(torch.zeros(1, 8, 2, 64), torch.zeros(1, 8, 1, 64),
                           torch.zeros(1, 8, 1, 64))
    fa.flash_attention(*(torch.zeros(1, 8, 1, 64) for _ in range(3)))
    assert fa.LAUNCHES == before  # the CPU path never counts a kernel launch
