"""The port's log-mel front end (``versband_tpu_torch/dsp/mel.py``) against
``versband_tpu.dsp.mel`` (CPU).

Bars: the filterbank and window exactly (both numpy, the same code); the
magnitude STFT 1e-4 relative to its largest value; the log-mel 1e-4 absolute,
the JAX module's own bar against the reference (``dsp/mel.py:164-169``); the
gradient of a mel L1 (the HiFi-GAN recipe's term) 1e-4 of its scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.dsp import mel as jm
from versband_tpu_torch.dsp import mel as pm

MEL_TOL = 1e-4


def _wav(seed=0, B=2, n=24000 // 4):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 24000.0
    sig = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1320 * t)
    sig = sig[None] + 0.05 * rng.standard_normal((B, n))
    return np.clip(sig, -1, 1).astype(np.float32)


def test_constants_equal():
    np.testing.assert_array_equal(pm.mel_filterbank(24000, 1280, 80, 0.0, 8000.0),
                                  jm.mel_filterbank(24000, 1280, 80, 0.0, 8000.0))
    np.testing.assert_array_equal(pm.mel_filterbank(22050, 1024, 64, 50.0, 7000.0),
                                  jm.mel_filterbank(22050, 1024, 64, 50.0, 7000.0))
    np.testing.assert_array_equal(pm.hann_window(1280), jm.hann_window(1280))


def test_config_from_hparams():
    hp = {"audio_sample_rate": 22050, "audio_num_mel_bins": 64, "fft_size": 1024,
          "win_size": 1024, "hop_size": 256, "fmin": 50.0, "fmax": 7000.0}
    a, b = pm.MelConfig.from_hparams(hp), jm.MelConfig.from_hparams(hp)
    assert (a.sample_rate, a.n_mels, a.n_fft, a.win_size, a.hop_size, a.fmin, a.fmax,
            a.pad) == (b.sample_rate, b.n_mels, b.n_fft, b.win_size, b.hop_size, b.fmin,
                       b.fmax, b.pad)
    assert pm.MelConfig() == pm.DEFAULT_MEL_CONFIG and pm.MelConfig().pad == 480


@pytest.mark.parametrize("use_fft", [False, True], ids=["matmul_dft", "rfft"])
def test_stft_magnitude(use_fft):
    y = _wav(1)[:, :4000]
    win = pm.hann_window(1280)
    got = pm.stft_magnitude(torch.from_numpy(y), torch.from_numpy(win), 1280, 320, use_fft)
    ref = np.asarray(jm.stft_magnitude(jnp.asarray(y), jnp.asarray(win), 1280, 320,
                                       use_fft=use_fft))
    assert got.shape == ref.shape == (2, 641, 1 + (4000 - 1280) // 320)
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("use_fft", [False, True], ids=["matmul_dft", "rfft"])
@pytest.mark.parametrize("n", [6000, 6001, 8320])
def test_log_mel_matches_jax(use_fft, n):
    y = _wav(2, n=n)
    got = pm.MelSpectrogram(use_fft=use_fft)(torch.from_numpy(y))
    ref = np.asarray(jm.MelSpectrogram(use_fft=use_fft)(y))
    assert got.shape == ref.shape == (2, 80, pm.MelSpectrogram().num_frames(n))
    assert pm.MelSpectrogram().num_frames(n) == jm.MelSpectrogram().num_frames(n)
    np.testing.assert_allclose(got.numpy(), ref, atol=MEL_TOL, rtol=0)


def test_one_waveform_and_clipping():
    y = 1.5 * _wav(3, B=1)[0]
    got = pm.MelSpectrogram()(torch.from_numpy(y))
    ref = np.asarray(jm.MelSpectrogram()(y))
    assert got.shape == (1, 80, ref.shape[-1])
    np.testing.assert_allclose(got.numpy(), ref, atol=MEL_TOL, rtol=0)


def test_mel_l1_gradient_matches_jax():
    y, target = _wav(4), _wav(5)
    t = torch.from_numpy(y).requires_grad_(True)
    mel_fn = pm.MelSpectrogram()
    loss = torch.mean(torch.abs(mel_fn(t) - mel_fn(torch.from_numpy(target))))
    loss.backward()
    jfn = jm.MelSpectrogram()
    ref = jax.grad(lambda w: jnp.mean(jnp.abs(jfn(w) - jfn(target))))(jnp.asarray(y))
    ref = np.asarray(ref)
    assert np.abs(t.grad.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_range_compression_round_trip():
    x = torch.tensor([1e-7, 1e-3, 0.5, 3.0])
    c = pm.dynamic_range_compression(x)
    np.testing.assert_allclose(c.numpy(), np.asarray(jm.dynamic_range_compression(
        jnp.asarray(x.numpy()))), rtol=1e-6)
    np.testing.assert_allclose(pm.dynamic_range_decompression(c).numpy(),
                               np.maximum(x.numpy(), 1e-5), rtol=1e-5)
