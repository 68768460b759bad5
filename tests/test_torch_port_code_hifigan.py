"""The port's ``CodeUpsampleHifiGanGenerator`` and the trainable HiFi-GAN
against ``versband_tpu.vocoder.hifigan`` (fp32, CPU, tiny widths).

The token resize is ``jax.image.resize(..., "linear")``: growing it is
``F.interpolate(mode="linear", align_corners=False)``; shrinking, JAX
antialiases (a triangle kernel widened by the ratio) and ``F.interpolate``
does not. Weights come from the JAX init through ``state_dict_from_jax``
(``code_hifigan``, ``hifigan``). Bars: forwards 2e-4, the HiFi-GAN bar of
docs/PARITY.md; the resize weights 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from versband_tpu.vocoder import hifigan as jh
from versband_tpu_torch.utils.config import get_obj_from_str
from versband_tpu_torch.utils.convert import state_dict_from_jax
from versband_tpu_torch.vocoder import hifigan as ph
from versband_tpu_torch.vocoder.conv import fold_weight_norm_

TOL = 2e-4
CODE_TINY = dict(code_num=10, codebook_num=2, code_emb_dim=8, upsample_initial_channel=16,
                 upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                 resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),))


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("n_in,n_out", [(7, 14), (7, 10), (12, 5), (10, 3), (6, 6)])
def test_resize_matrix_is_jax_image_resize(n_in, n_out):
    x = np.random.RandomState(n_in * n_out).randn(2, n_in, 3).astype(np.float32)
    w = ph.linear_resize_matrix(n_in, n_out)
    got = np.einsum("btc,to->boc", x, w)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, n_out, 3), "linear"))
    _close(got, ref, 1e-6)
    if n_out >= n_in:  # growing: torch's linear interpolation
        t = F.interpolate(torch.from_numpy(x).transpose(1, 2), size=n_out, mode="linear",
                          align_corners=False).transpose(1, 2)
        _close(t, ref, 1e-6)


@pytest.mark.parametrize("rate", [1.0, 2.0, 0.5])
def test_code_generator_matches_jax(rate):
    rng = np.random.RandomState(int(rate * 10))
    codes = rng.randint(0, 12, (2, 2, 6))  # ids past code_num clamp onto the pad id
    jm = jh.CodeUpsampleHifiGanGenerator(**CODE_TINY, unit_upsample_rate=rate)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(codes))
    port = ph.CodeUpsampleHifiGanGenerator(**CODE_TINY, unit_upsample_rate=rate).eval()
    port.load_state_dict(state_dict_from_jax(params, "code_hifigan"))
    with torch.no_grad():
        got = port(torch.from_numpy(codes))
    ref = jm.apply(params, jnp.asarray(codes))
    assert got.shape == (2, int(6 * rate) * 4)
    _close(got, ref)


def test_code_generator_is_a_config_target():
    cls = get_obj_from_str("vocoder.hifigan.modules.hifigan.CodeUpsampleHifiGanGenerator")
    assert cls is ph.CodeUpsampleHifiGanGenerator
    with pytest.raises(ValueError, match="codebooks"):
        cls(**CODE_TINY)(torch.zeros(1, 3, 4, dtype=torch.long))


def test_trainable_hifigan_matches_jax_and_folds():
    kw = dict(upsample_initial_channel=16, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
              resblock="2", resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3),) * 2)
    mel = np.random.RandomState(1).randn(2, 80, 7).astype(np.float32)
    jm = jh.HifiGanGenerator(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(mel))
    ref = jm.apply(params, jnp.asarray(mel))
    port = ph.HifiGanGenerator(**kw, use_weight_norm=True).eval()
    port.load_state_dict(state_dict_from_jax(params, "hifigan", weight_norm=True))
    names = dict(port.named_parameters())
    assert names["ups.0.weight_g"].shape == (1, 8, 1) and names["ups.0.weight_v"].shape == (16, 8, 8)
    assert names["conv_pre.weight_g"].shape == (16, 1, 1) and "conv_pre.weight" not in names
    with torch.no_grad():
        _close(port(torch.from_numpy(mel)), ref)
    fold_weight_norm_(port)
    assert set(port.state_dict()) == set(ph.HifiGanGenerator(**kw).state_dict())
    with torch.no_grad():
        _close(port(torch.from_numpy(mel)), ref)
    # the folded form equals the serving family's conversion of the same tree
    for k, v in state_dict_from_jax(params, "hifigan").items():
        torch.testing.assert_close(port.state_dict()[k], v, rtol=1e-5, atol=1e-7)
