"""K4's plain version (the CPU path of ``fused_alias_free_snake``) against
``versband_tpu`` (fp32, CPU).

The port takes ``[B, C, T]`` where the JAX entry takes ``[B, T, C]``: inputs
and outputs are transposed here. Against the JAX Pallas kernel in interpret
mode at the shapes it takes, and against the JAX unfused modules
(``UpSample1d -> snake -> DownSample1d``, the oracle of
``tests/test_fused_act1d.py``) at ragged T where the JAX entry returns None.
Tolerance 2e-5 x max(1, max|ref|), the JAX test's own bar (fp32 FIRs and
sin in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.ops.fused_act1d import fused_alias_free_snake as jax_fused
from versband_tpu.vocoder import bigvgan as jb
from versband_tpu_torch.ops import fused_act1d as fa1

TOL = 2e-5


def _inputs(seed, B, C, T, beta=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, C, T).astype(np.float32)
    alpha = (rng.randn(C) * 0.3).astype(np.float32)
    b = (rng.randn(C) * 0.3).astype(np.float32) if beta else None
    return x, alpha, b


def _port(x, alpha, beta, logscale):
    before = fa1.LAUNCHES
    out = fa1.fused_alias_free_snake(torch.from_numpy(x), torch.from_numpy(alpha),
                                     None if beta is None else torch.from_numpy(beta), logscale)
    assert fa1.LAUNCHES == before  # a CPU tensor never reaches the kernel
    return out.numpy()


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * max(1.0, np.abs(ref).max()))


def _jax_unfused(x, alpha, beta, logscale, ratio=2):
    xt = jnp.asarray(x.transpose(0, 2, 1))
    y = jb.UpSample1d(ratio).apply({"params": {}}, xt)
    y = jb.snake(y, jnp.asarray(alpha), None if beta is None else jnp.asarray(beta), logscale)
    return np.asarray(jb.DownSample1d(ratio).apply({"params": {}}, y)).transpose(0, 2, 1)


@pytest.mark.parametrize("args", [(0.25, 0.3, 12), (0.5 / 3, 0.6 / 3, 18), (0.2, 0.3, 11),
                                  (0.0, 0.3, 12)])
def test_kaiser_sinc_filter_is_the_jax_one(args):
    np.testing.assert_array_equal(fa1.kaiser_sinc_filter1d(*args), jb.kaiser_sinc_filter1d(*args))


@pytest.mark.parametrize("B,T,C", [(1, 64, 8), (1, 37, 8), (2, 64, 16)])
def test_plain_matches_the_jax_kernel(B, T, C):
    """Against the Pallas kernel itself (interpret mode), SnakeBeta, logscale."""
    x, alpha, beta = _inputs(B * T + C, B, C, T)
    ref = jax_fused(jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(alpha), jnp.asarray(beta),
                    True, interpret=True)
    assert ref is not None
    _close(_port(x, alpha, beta, True), np.asarray(ref).transpose(0, 2, 1))


@pytest.mark.parametrize("T", [1, 5, 37])
@pytest.mark.parametrize("variant", ["snake", "snakebeta"])
@pytest.mark.parametrize("logscale", [True, False])
def test_plain_matches_the_jax_unfused_modules(T, variant, logscale):
    """Ragged T, where the JAX entry gives up (T = 5 returns None): the
    replicate edges of x and of the 2T signal reach every output."""
    x, alpha, beta = _inputs(T, 2, 3, T, beta=variant == "snakebeta")
    if T == 5:
        assert jax_fused(jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(alpha),
                         None if beta is None else jnp.asarray(beta), logscale) is None
    _close(_port(x, alpha, beta, logscale), _jax_unfused(x, alpha, beta, logscale))


@pytest.mark.parametrize("ratio,T", [(2, 5), (2, 37), (3, 5), (3, 37)])
def test_resamplers_match_jax(ratio, T):
    x = np.random.RandomState(ratio * T).randn(2, 3, T).astype(np.float32)
    xt = jnp.asarray(x.transpose(0, 2, 1))
    up = fa1.upsample1d(torch.from_numpy(x), ratio).numpy()
    _close(up, np.asarray(jb.UpSample1d(ratio).apply({"params": {}}, xt)).transpose(0, 2, 1))
    down = fa1.downsample1d(torch.from_numpy(x), ratio).numpy()
    _close(down, np.asarray(jb.DownSample1d(ratio).apply({"params": {}}, xt)).transpose(0, 2, 1))


def test_snake_matches_jax():
    x, alpha, beta = _inputs(7, 2, 4, 9)
    for b in (beta, None):
        for logscale in (True, False):
            got = fa1.snake(torch.from_numpy(x), torch.from_numpy(alpha),
                            None if b is None else torch.from_numpy(b), logscale).numpy()
            ref = jb.snake(jnp.asarray(x), jnp.asarray(alpha)[:, None],
                           None if b is None else jnp.asarray(b)[:, None], logscale)
            _close(got, ref)


def test_bf16_on_the_cpu_keeps_its_type():
    x, alpha, beta = _inputs(11, 1, 4, 50)
    ref = fa1.alias_free_snake_reference(torch.from_numpy(x), torch.from_numpy(alpha),
                                         torch.from_numpy(beta))
    out = fa1.fused_alias_free_snake(torch.from_numpy(x).bfloat16(), torch.from_numpy(alpha),
                                     torch.from_numpy(beta))
    assert out.dtype == torch.bfloat16 and out.shape == (1, 4, 50)
    # bf16 input (2^-9 relative) and output rounding, fp32 math in between
    assert (out.float() - ref).abs().max() <= 2e-2 * ref.abs().max()


def test_rejects_other_devices_and_shapes():
    x = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa1.fused_alias_free_snake(x, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match=r"\[B, C, T\]"):
        fa1.fused_alias_free_snake(torch.zeros(2, 8), torch.zeros(2))
