"""F3: a reflect pad as long as the signal (CPU).

``jnp.pad(mode="reflect")`` keeps folding past the signal's edge, as
``numpy.pad`` does; torch's ``F.pad(mode="reflect")`` raises there. The port
pads through ``dsp/mel.py::reflect_pad`` at every site the JAX package pads
by reflection: the log-mel, the MR-STFT magnitude, MRD's spectrogram,
MPD's period pad and the MelGAN generator's pads. Each site is held to JAX at the lengths where torch's pad
raised (ROADMAP Queue 3, F3) and at one length above them, with the bars the
sites met above the limit before the fix: the log-mel 1e-5 absolute (2.4e-7
measured), the magnitudes 6e-6 of their scale (3.8e-6 and 5.7e-6), MPD at
the discriminator bar, 2e-4 of its scale, and MelGAN at the vocoder bar,
2e-4 of its scale. The helper is held to
``numpy.pad`` bit for bit for pads of 1-4x the signal, and its gradient to
the transposed gather.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.dsp import mel as jm
from versband_tpu.vocoder import discriminators as jd
from versband_tpu.vocoder import losses as jl
from versband_tpu.vocoder import pwg as jp
from versband_tpu_torch.dsp import mel as pm
from versband_tpu_torch.utils.convert import state_dict_from_jax
from versband_tpu_torch.vocoder import discriminators as pd
from versband_tpu_torch.vocoder import losses as pl
from versband_tpu_torch.vocoder import pwg as pp


def _noise(shape, seed):
    return np.random.RandomState(seed).uniform(-0.9, 0.9, shape).astype(np.float32)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1e-30, np.abs(ref).max()))


@pytest.mark.parametrize("n", [1, 2, 3, 7])
@pytest.mark.parametrize("mult", [1, 2, 3, 4])
def test_helper_folds_as_numpy(n, mult):
    x = _noise((2, 3, n), n)
    for left, right in ((mult * n, mult * n), (mult * n, 0), (0, mult * n + 1), (n - 1, mult * n)):
        got = pm.reflect_pad(torch.from_numpy(x), left, right).numpy()
        np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (0, 0), (left, right)),
                                                  mode="reflect"))


def test_helper_gradient_is_the_transposed_gather():
    n, left, right = 5, 13, 9
    x = torch.from_numpy(_noise((2, n), 0).astype(np.float64)).requires_grad_(True)
    w = torch.from_numpy(_noise((2, n + left + right), 1).astype(np.float64))
    (pm.reflect_pad(x, left, right) * w).sum().backward()
    # d/dx_j of sum_i w_i x_{idx(i)} = sum of w_i over the i that read j
    idx = np.pad(np.arange(n), (left, right), mode="reflect")
    want = np.zeros((2, n))
    for i, j in enumerate(idx):
        want[:, j] += w[:, i].numpy()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-12)
    torch.autograd.gradcheck(lambda t: pm.reflect_pad(t, left, right), (x,))


@pytest.mark.parametrize("n", [320, 400, 480, 481])  # the pad is 480: the last is above it
def test_log_mel_short_clips(n):
    y = _noise((1, n), n)
    got = pm.MelSpectrogram()(torch.from_numpy(y)).numpy()
    ref = np.asarray(jm.MelSpectrogram()(jnp.asarray(y)))
    assert got.shape == ref.shape == (1, 80, 1 + (n + 960 - 1280) // 320)
    assert np.abs(got - ref).max() <= 1e-5


@pytest.mark.parametrize("n", [600, 1024, 1025])  # fft 2048 pads by 1024
def test_mr_stft_magnitude_short_clips(n):
    x = _noise((2, n), n)
    got = pl.stft_magnitude(torch.from_numpy(x), 2048, 240, 1200).numpy()
    ref = np.asarray(jl.stft_magnitude(jnp.asarray(x), 2048, 240, 1200))
    assert got.shape == ref.shape
    if n == 600:
        assert ref.shape == (2, 3, 1025)
    assert _rel(got, ref) <= 6e-6


@pytest.mark.parametrize("n", [600, 961])  # MRD 2048/512 pads by 768
def test_mrd_spectrogram_short_clips(n):
    x = _noise((2, n), n)
    got = pd._stft_mag(torch.from_numpy(x), 2048, 512, 2048).numpy()
    ref = np.asarray(jd._stft_mag(jnp.asarray(x), 2048, 512, 2048))
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 6e-6


def test_mpd_period_pad_short_clips():
    """The period-11 discriminator: at T = 3 its pad of 8 samples exceeds the
    signal; at T = 23 the pad of 10 is within it."""
    jmod = jd.MultiPeriodDiscriminator(periods=(11,))
    y = _noise((1, 1, 23), 23) * 0.5
    apply = jax.jit(jmod.apply)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(y))
    port = pd.MultiPeriodDiscriminator(periods=(11,))
    port.load_state_dict(state_dict_from_jax(params, "mpd"))
    for T in (3, 23):
        y = _noise((1, 1, T), T) * 0.5
        got = port(torch.from_numpy(y), torch.from_numpy(y))
        ref = apply(params, jnp.asarray(y), jnp.asarray(y))
        for g, r in zip(got[0], ref[0]):
            assert _rel(g.detach().numpy(), r) <= 2e-4, T


def test_melgan_generator_short_mels():
    """MelGAN pads by 3 before its first and last convs and by the stack's
    dilation (1 and 3 here) in each residual stack: mels of 1-3 frames
    reach past the signal at conv_in, and 1 frame (2 samples after the first
    upsampling) in the stacks too; 4 frames are within every pad."""
    kw = dict(in_channels=20, channels=16, upsample_scales=(2, 3), stacks=2)
    jmod = jp.MelGANGenerator(**kw)
    c = _noise((1, 20, 4), 4)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(c))
    port = pp.MelGANGenerator(**kw).eval()
    port.load_state_dict(state_dict_from_jax(params, "melgan", weight_norm=True))
    for T in (1, 2, 3, 4):
        c = _noise((1, 20, T), T)
        with torch.no_grad():
            got = port(torch.from_numpy(c)).numpy()
        ref = jmod.apply(params, jnp.asarray(c))
        assert got.shape == (1, 1, 6 * T)
        assert _rel(got, ref) <= 2e-4, T


def test_losses_backpropagate_through_long_pads():
    """The MR-STFT loss at 600 samples (each resolution's pad of 512-1024
    reaches past the signal) has the JAX gradient."""
    x, y = _noise((1, 600), 5), _noise((1, 600), 6)
    xt = torch.from_numpy(x).requires_grad_(True)
    sc, mag = pl.multi_resolution_stft_loss(xt, torch.from_numpy(y))
    (sc + mag).backward()
    ref = jax.jit(jax.grad(lambda a: sum(jl.multi_resolution_stft_loss(a, jnp.asarray(y)))))(
        jnp.asarray(x))
    assert _rel(xt.grad.numpy(), ref) <= 1e-4
