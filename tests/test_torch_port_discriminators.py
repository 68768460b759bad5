"""The port's vocoder discriminators and GAN losses against
``versband_tpu.vocoder.discriminators`` (fp32, CPU).

Weights come from the JAX init through ``state_dict_from_jax`` (families
``mpd``, ``msd``, ``mrd``, ``mwd``), so the port's trainable (v, g) and
``weight_orig`` parameters are held to JAX's. Bars: scores and feature maps
2e-4 of their scale, the HiFi-GAN bar of docs/PARITY.md; losses 1e-5
relative; spectral norm 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.vocoder import discriminators as jd
from versband_tpu_torch.utils.convert import state_dict_from_jax
from versband_tpu_torch.vocoder import conv as pc
from versband_tpu_torch.vocoder import discriminators as pd

TOL = 2e-4


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max())


def _nhwc(f):
    """A JAX feature map (NWC / NHWC) in the port's channel-first layout."""
    f = np.asarray(f)
    return f.transpose(0, 2, 1) if f.ndim == 3 else f.transpose(0, 3, 1, 2)


def _check_multi(port_out, jax_out):
    for got_list, ref_list in zip(port_out[:2], jax_out[:2]):  # scores
        assert len(got_list) == len(ref_list)
        for g, r in zip(got_list, ref_list):
            _close(g.detach(), r)
    for got_maps, ref_maps in zip(port_out[2:], jax_out[2:]):  # feature maps
        for gd, rd in zip(got_maps, ref_maps):
            assert len(gd) == len(rd)
            for g, r in zip(gd, rd):
                _close(g.detach(), _nhwc(r))


def _wavs(seed, B=2, T=203):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 1, T).astype(np.float32) * 0.5,
            rng.randn(B, 1, T).astype(np.float32) * 0.5)


def _load(port, jmod, y, y_hat, family):
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(y_hat))
    port.load_state_dict(state_dict_from_jax(params, family))
    return params


@pytest.mark.parametrize("T", [203, 210])  # ragged for every period / a multiple of 2, 3, 5, 7
def test_mpd(T):
    y, y_hat = _wavs(0, T=T)
    jmod = jd.MultiPeriodDiscriminator()
    port = pd.MultiPeriodDiscriminator()
    params = _load(port, jmod, y, y_hat, "mpd")
    assert "discriminators.4.convs.0.weight_g" in port.state_dict()
    assert port.discriminators[0].convs[0].weight_g.shape == (32, 1, 1, 1)
    ref = jax.jit(jmod.apply)(params, jnp.asarray(y), jnp.asarray(y_hat))
    _check_multi(port(torch.from_numpy(y), torch.from_numpy(y_hat)), ref)


def test_msd_pools_as_jax_and_first_scale_is_spectral():
    y, y_hat = _wavs(1, T=260)
    jmod = jd.MultiScaleDiscriminator()
    port = pd.MultiScaleDiscriminator()
    params = _load(port, jmod, y, y_hat, "msd")
    sd = port.state_dict()
    assert "discriminators.0.convs.3.weight_orig" in sd and \
        "discriminators.0.convs.3.weight_v" not in sd
    assert "discriminators.1.convs.3.weight_v" in sd
    ref = jax.jit(jmod.apply)(params, jnp.asarray(y), jnp.asarray(y_hat))
    out = port(torch.from_numpy(y), torch.from_numpy(y_hat))
    _check_multi(out, ref)
    # JAX pools 260 -> 130 -> 65 (padding 1); upstream's padding 2 gives 131 -> 66
    assert [x.shape[-1] for x in port.inputs(torch.zeros(1, 1, 260))] == [260, 130, 65]


@pytest.mark.parametrize("res,mult,T", [(((64, 16, 32), (128, 32, 64)), 0.25, 300),
                                        (((1024, 120, 600), (2048, 240, 1200),
                                          (512, 50, 240)), 1.0, 1200)],
                         ids=["small", "default"])
def test_mrd(res, mult, T):
    y, y_hat = _wavs(2, T=T)
    jmod = jd.MultiResolutionDiscriminator(res, mult)
    port = pd.MultiResolutionDiscriminator(res, mult)
    params = _load(port, jmod, y, y_hat, "mrd")
    ref = jax.jit(jmod.apply)(params, jnp.asarray(y), jnp.asarray(y_hat))
    _check_multi(port(torch.from_numpy(y), torch.from_numpy(y_hat)), ref)


def test_stft_mag():
    x = np.random.RandomState(3).randn(2, 500).astype(np.float32)
    for n_fft, hop, win in ((128, 32, 64), (64, 16, 64)):
        _close(pd._stft_mag(torch.from_numpy(x), n_fft, hop, win),
               jd._stft_mag(jnp.asarray(x), n_fft, hop, win))


def test_multi_window_discriminator():
    x = np.random.RandomState(4).randn(2, 24, 10).astype(np.float32)
    jmod = jd.MultiWindowDiscriminator((8, 16, 5), freq_length=10, hidden_size=8)
    starts = (3, 20, 0)  # 20 is clamped to 24 - 16 = 8, as lax.dynamic_slice clamps
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), starts)
    port = pd.MultiWindowDiscriminator((8, 16, 5), freq_length=10, hidden_size=8)
    port.load_state_dict(state_dict_from_jax(params, "mwd"))
    v, feats = port(torch.from_numpy(x), starts)
    rv, rfeats = jmod.apply(params, jnp.asarray(x), starts)
    _close(v.detach(), rv)
    for g, r in zip(feats, rfeats):
        _close(g.detach(), _nhwc(r))


def test_spectral_norm_is_jax_stateless_form():
    """Three power iterations from ones/sqrt(n) on every call: the same
    estimate as JAX's, the same on a second call, and not converged on a
    matrix whose top singular values are close. ``torch.nn.utils.spectral_norm``
    (a random persistent u, one iteration per training forward) gives another
    weight here."""
    rng = np.random.RandomState(5)
    u, _ = np.linalg.qr(rng.randn(12, 12))
    v, _ = np.linalg.qr(rng.randn(40, 12))
    s = np.array([1.0, 0.97, 0.95] + [0.1] * 9)
    mat = (u * s) @ v.T  # [C_out 12, 40]: rows of the torch layout
    w = mat.reshape(12, 8, 5).astype(np.float32)  # torch Conv1d [out, in, k]
    flax_w = w.transpose(2, 1, 0)  # [k, in, out]
    got = pc.spectral_normalize(torch.from_numpy(w))
    ref = np.asarray(jd._spectral_normalize(jnp.asarray(flax_w))).transpose(2, 1, 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(pc.spectral_normalize(torch.from_numpy(w)), got, rtol=0, atol=0)
    sigma_est = w.reshape(12, -1)[0, 0] / got.numpy().reshape(12, -1)[0, 0]
    assert abs(sigma_est - 1.0) > 1e-4  # not the converged sigma_max: 3 iterations only

    conv = torch.nn.Conv1d(8, 12, 5, bias=False)
    conv.weight.data = torch.from_numpy(w.copy())
    torch.manual_seed(0)
    torch_sn = torch.nn.utils.spectral_norm(conv, n_power_iterations=1)
    with torch.no_grad():
        torch_sn(torch.zeros(1, 8, 5))
    assert (torch_sn.weight - got).abs().max() > 1e-3


def test_norm_conv_options():
    conv = pd.norm_conv(torch.nn.Conv2d(2, 3, (5, 1)), "none")
    assert type(conv) is torch.nn.Conv2d
    with pytest.raises(ValueError, match="norm"):
        pd.norm_conv(torch.nn.Conv1d(2, 3, 3), "batch")
    x = torch.randn(1, 2, 9)
    plain = torch.nn.Conv1d(2, 3, 3)
    ref = plain(x)
    wn = pc.weight_norm(plain)
    assert set(dict(wn.named_parameters())) == {"weight_v", "weight_g", "bias"}
    torch.testing.assert_close(wn(x), ref)


def test_loss_helpers_match_jax():
    rng = np.random.RandomState(6)
    real = [rng.randn(2, 7).astype(np.float32) for _ in range(3)]
    fake = [rng.randn(2, 7).astype(np.float32) for _ in range(3)]
    fr = [[rng.randn(2, 3, 5).astype(np.float32) for _ in range(2)] for _ in range(3)]
    fg = [[rng.randn(2, 3, 5).astype(np.float32) for _ in range(2)] for _ in range(3)]
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    j = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    pairs = [
        (pd.feature_loss([t(a) for a in fr], [t(b) for b in fg]),
         jd.feature_loss([j(a) for a in fr], [j(b) for b in fg])),
        (pd.discriminator_loss(t(real), t(fake))[0], jd.discriminator_loss(j(real), j(fake))[0]),
        (pd.discriminator_loss(t(real), t(fake))[1], jd.discriminator_loss(j(real), j(fake))[1]),
        (pd.generator_loss(t(fake)), jd.generator_loss(j(fake))),
        (pd.cond_discriminator_loss(t(fake)), jd.cond_discriminator_loss(j(fake))),
    ]
    for got, ref in pairs:
        assert float(got) == pytest.approx(float(ref), rel=1e-5)


def test_discriminator_gradients_match_jax():
    """d(LSGAN loss)/d(weight_v, weight_g, bias) of one period and one scale
    discriminator: the trainable parametrisation is JAX's."""
    y, y_hat = _wavs(7, T=150)
    for jmod, port, fam in ((jd.MultiPeriodDiscriminator((3,)),
                             pd.MultiPeriodDiscriminator((3,)), "mpd"),
                            (jd.MultiScaleDiscriminator(), pd.MultiScaleDiscriminator(), "msd")):
        params = _load(port, jmod, y, y_hat, fam)

        def loss_fn(p):
            rs, gs, _, _ = jmod.apply(p, jnp.asarray(y), jnp.asarray(y_hat))
            r, g = jd.discriminator_loss(rs, gs)
            return r + g

        jg = state_dict_from_jax(jax.jit(jax.grad(loss_fn))(params), fam)
        rs, gs, _, _ = port(torch.from_numpy(y), torch.from_numpy(y_hat))
        r, g = pd.discriminator_loss(rs, gs)
        (r + g).backward()
        scale = max(v.abs().max().item() for v in jg.values())
        for k, p in port.named_parameters():
            err = (p.grad - jg[k]).abs().max().item()
            assert err <= 1e-3 * max(jg[k].abs().max().item(), 1e-3 * scale), (fam, k, err)
