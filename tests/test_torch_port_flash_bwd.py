"""The flash-attention backward of the port (K2/K3's plain version and the
autograd Function) against the JAX package's.

On the CPU the port runs its plain backward (the dense formulas of
``_dq_kernel``/``_dkv_kernel``, P recomputed from the saved log-sum-exp); the
JAX side differentiates ``versband_tpu.ops.flash_attention`` through its
custom VJP, the Pallas kernels in interpret mode, as
tests/test_flash_attention.py runs them. Same q/k/v and upstream gradient,
made with numpy from a seed. Tolerance 2e-5 (fp32; summation order over up
to 72 keys). The CUDA kernels are held to the plain backward in
test_torch_port_cuda.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.ops.flash_attention import flash_attention as jax_flash
from versband_tpu_torch.ops import flash_attention as fa

TOL = 2e-5


def _inputs(seed, B, Tq, Tk, H, D):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) for T in (Tq, Tk, Tk, Tq)]


def _jax_grads(q, k, v, g, kv_len, scale):
    kv = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)

    def f(q, k, v):
        return jnp.sum(jax_flash(q, k, v, kv, scale) * g)

    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("B,Tq,Tk,H,D,kv_len,scale", [
    (2, 40, 40, 2, 64, None, None),          # unmasked
    (2, 24, 56, 2, 96, None, None),          # Tq != Tk
    (3, 24, 72, 2, 96, [72, 0, 17], None),   # varlen with a kv_len = 0 row
    (1, 32, 48, 1, 64, None, 0.3),           # a given scale
])
def test_plain_backward_matches_jax_grad(B, Tq, Tk, H, D, kv_len, scale):
    q, k, v, g = _inputs(B * 100 + Tk, B, Tq, Tk, H, D)
    kv = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, kv, scale)
    got = fa.flash_attention_bwd(tq, tk, tv, kv, out, lse, tg, scale)
    ref = _jax_grads(q, k, v, jnp.asarray(g), kv_len, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL, rtol=TOL, err_msg=name)
    if kv_len is not None:
        for a in got:
            np.testing.assert_array_equal(a[1].numpy(), 0.0)  # the kv_len = 0 row


def test_autograd_function_on_cpu_has_grad_fn_and_the_plain_grads():
    """flash_attention is differentiable (the graph is not cut at the
    attention) and its gradient is the plain backward's."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(7, 2, 24, 40, 2, 64))
    kv_len = torch.tensor([40, 9], dtype=torch.int32)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
    out = fa.flash_attention(q, k, v, kv_len)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV) == before  # no kernel on the CPU
    o, lse = fa.flash_attention_fwd(q.detach(), k.detach(), v.detach(), kv_len)
    ref = fa.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(), kv_len, o,
                                           lse, g)
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # and it is the gradient of dense masked attention
    qd, kd, vd = (t.detach().clone().requires_grad_() for t in (q, k, v))
    dense = fa._reference_fwd(qd, kd, vd, kv_len, 1 / math.sqrt(64))[0]
    for a, b in zip(grads, torch.autograd.grad(dense, (qd, kd, vd), g)):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def test_attention_in_the_model_gets_gradients_with_use_flash():
    """The fault this pins: wq/wk/wv of a JointAttention got no gradient
    through the flash path. With use_flash they must get the sdpa path's."""
    from versband_tpu_torch.nn.core import JointAttention, precompute_rope

    torch.manual_seed(0)
    flash = JointAttention(32, 2, use_flash=True)
    plain = JointAttention(32, 2, use_flash=False)
    plain.load_state_dict(flash.state_dict())
    cos, sin = (torch.from_numpy(a) for a in precompute_rope(16, 16))
    x = torch.randn(2, 12, 32)
    for m in (flash, plain):
        m(x, None, cos, sin).square().sum().backward()
    for (name, a), b in zip(flash.named_parameters(), plain.parameters()):
        assert a.grad is not None and a.grad.abs().max() > 0, name
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-5)


def test_bwd_other_devices_and_shapes_raise():
    q = torch.zeros(1, 8, 1, 64, device="meta")
    lse = torch.zeros(1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention_bwd(q, q, q, None, q, lse, q)
    c = torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_bwd(c, c, c, None, c, lse, c[:, :4])
