"""The port's multi-resolution STFT loss (``versband_tpu_torch/vocoder/losses.py``)
against ``versband_tpu.vocoder.losses`` (fp32, CPU).

Bars: magnitudes 1e-5 of their scale (rFFT in another order); losses 1e-5
relative; the loss's gradient 1e-3 of its scale, the bar of
``torch_port_helpers.assert_grads_match``: the log-magnitude term's
gradient is 1/|X| times the rFFT's rounding, largest at the weakest bins
(measured 1.2e-4 at the 512-point resolution).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.vocoder import losses as jl
from versband_tpu_torch.vocoder import losses as pl


def _pair(seed, B=2, T=3000):
    rng = np.random.RandomState(seed)
    y = (0.3 * np.sin(np.arange(T) * 0.05)[None] + 0.1 * rng.randn(B, T)).astype(np.float32)
    x = (y + 0.05 * rng.randn(B, T)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("fft,hop,win", [(1024, 120, 600), (512, 50, 240), (256, 64, 256)])
def test_stft_magnitude(fft, hop, win):
    x, _ = _pair(0)
    got = pl.stft_magnitude(torch.from_numpy(x), fft, hop, win).numpy()
    ref = np.asarray(jl.stft_magnitude(jnp.asarray(x), fft, hop, win))
    assert got.shape == ref.shape == (2, 1 + 3000 // hop, fft // 2 + 1)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert got.min() >= np.sqrt(1e-7) * (1 - 1e-6)  # the clamp


def test_window_is_periodic_hann_centred():
    w = pl.padded_hann(600, 1024).numpy()
    assert w.shape == (1024,) and w[:212].max() == 0 and w[812:].max() == 0
    np.testing.assert_allclose(w[212:812], np.hanning(601)[:-1], rtol=1e-6)


def test_losses_match_jax():
    x, y = _pair(1)
    xm, ym = (pl.stft_magnitude(torch.from_numpy(a), 512, 50, 240) for a in (x, y))
    jxm, jym = (jl.stft_magnitude(jnp.asarray(a), 512, 50, 240) for a in (x, y))
    assert float(pl.spectral_convergence_loss(xm, ym)) == pytest.approx(
        float(jl.spectral_convergence_loss(jxm, jym)), rel=1e-5)
    assert float(pl.log_stft_magnitude_loss(xm, ym)) == pytest.approx(
        float(jl.log_stft_magnitude_loss(jxm, jym)), rel=1e-5)
    for got, ref in zip(pl.stft_loss(torch.from_numpy(x), torch.from_numpy(y)),
                        jl.stft_loss(jnp.asarray(x), jnp.asarray(y))):
        assert float(got) == pytest.approx(float(ref), rel=1e-5)
    for got, ref in zip(pl.multi_resolution_stft_loss(torch.from_numpy(x), torch.from_numpy(y)),
                        jl.multi_resolution_stft_loss(jnp.asarray(x), jnp.asarray(y))):
        assert float(got) == pytest.approx(float(ref), rel=1e-5)


def test_multi_resolution_gradient_matches_jax():
    x, y = _pair(2)
    t = torch.from_numpy(x).requires_grad_(True)
    sc, mag = pl.multi_resolution_stft_loss(t, torch.from_numpy(y))
    (sc + mag).backward()
    ref = jax.grad(lambda a: sum(jl.multi_resolution_stft_loss(a, jnp.asarray(y))))(
        jnp.asarray(x))
    ref = np.asarray(ref)
    assert np.abs(t.grad.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()


def test_identical_signals_give_zero_loss():
    _, y = _pair(3)
    sc, mag = pl.multi_resolution_stft_loss(torch.from_numpy(y), torch.from_numpy(y))
    assert float(sc) == 0.0 and float(mag) == 0.0
