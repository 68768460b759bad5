"""The rest of the port's ``vocoder/pwg.py`` against ``versband_tpu.vocoder.pwg``
(fp32, CPU, tiny widths): the ParallelWaveGAN discriminator, the trainable
and pitch-embedded generator, ``ResidualStack``, the MelGAN generator and
discriminators, and PQMF.

Weights come from the JAX init through ``state_dict_from_jax`` (families
``pwg_disc``, ``pwg``, ``melgan``, ``melgan_disc``), so the port's reference
key names and its (v, g) parametrisation are held to JAX's; the MelGAN
generator's names are also held to the JAX package's own converter
(``convert_melgan_state_dict``). Bars: forwards 2e-4, the vocoder bar of
docs/PARITY.md; PQMF 1e-5 (fixed filters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.utils.torch_convert import convert_melgan_state_dict
from versband_tpu.vocoder import pwg as jp
from versband_tpu_torch.utils.convert import state_dict_from_jax
from versband_tpu_torch.vocoder import pwg as pp
from versband_tpu_torch.vocoder.conv import fold_weight_norm_
from torch_port_helpers import PWG_TINY

TOL = 2e-4
MELGAN_TINY = dict(in_channels=20, channels=16, upsample_scales=(2, 3), stacks=2)
MELGAN_DISC_TINY = dict(channels=4, max_downsample_channels=16, downsample_scales=(2, 2))


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max())


def _init(jmod, *args):
    return jax.jit(jmod.init)(jax.random.PRNGKey(0), *[jnp.asarray(a) for a in args])


def test_pwg_discriminator():
    x = np.random.RandomState(0).randn(2, 1, 90).astype(np.float32)
    kw = dict(layers=5, conv_channels=8)
    jmod = jp.ParallelWaveGANDiscriminator(**kw)
    params = _init(jmod, x)
    port = pp.ParallelWaveGANDiscriminator(**kw)
    sd = state_dict_from_jax(params, "pwg_disc")
    assert {"conv_layers.0.weight_v", "conv_layers.6.weight_g", "conv_layers.8.bias"} <= set(sd)
    port.load_state_dict(sd)
    assert [m.dilation[0] for m in port.conv_layers[::2]] == [1, 1, 2, 3, 1]
    _close(port(torch.from_numpy(x)).detach(), jmod.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("weight_norm", [False, True], ids=["folded", "trainable"])
def test_pwg_generator_trainable_and_pitch_embedded(weight_norm):
    rng = np.random.RandomState(1)
    mel = rng.randn(2, 20, 14).astype(np.float32)
    noise = rng.randn(2, 1, 40).astype(np.float32)
    pitch = rng.randint(0, 300, (2, 14))
    jmod = jp.ParallelWaveGANGenerator(**PWG_TINY, use_pitch_embed=True)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.asarray(noise), jnp.asarray(mel),
                                jnp.asarray(pitch))
    port = pp.ParallelWaveGANGenerator(**PWG_TINY, use_pitch_embed=True,
                                       use_weight_norm=weight_norm).eval()
    port.load_state_dict(state_dict_from_jax(params, "pwg", weight_norm=weight_norm))
    if weight_norm:
        assert "conv_layers.0.conv.weight_g" in port.state_dict()
        assert "upsample_net.upsample.up_layers.1.weight" in port.state_dict()  # plain
    ref = jmod.apply(params, jnp.asarray(noise), jnp.asarray(mel), jnp.asarray(pitch))
    with torch.no_grad():
        got = port(torch.from_numpy(noise), torch.from_numpy(mel), torch.from_numpy(pitch))
    _close(got, ref)
    with torch.no_grad():  # without pitch the embedding is skipped, as in JAX
        _close(port(torch.from_numpy(noise), torch.from_numpy(mel)),
               jmod.apply(params, jnp.asarray(noise), jnp.asarray(mel)))


def test_pwg_fused_path_reads_the_weight_norm():
    """A trainable generator served fused (K5's plain version here) equals
    its dense path: the fused layer reads the (v, g) weight, not a stale one."""
    torch.manual_seed(2)
    dense = pp.ParallelWaveGANGenerator(**PWG_TINY, use_weight_norm=True).eval()
    fused = pp.ParallelWaveGANGenerator(**PWG_TINY, use_weight_norm=True,
                                        fused_inference=True).eval()
    with torch.no_grad():
        for p in dense.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    fused.load_state_dict(dense.state_dict())
    rng = np.random.RandomState(2)
    mel, noise = (torch.from_numpy(rng.randn(1, 20, 14).astype(np.float32)),
                  torch.from_numpy(rng.randn(1, 1, 40).astype(np.float32)))
    with torch.no_grad():
        torch.testing.assert_close(fused(noise, mel), dense(noise, mel), atol=1e-5, rtol=1e-5)


def test_residual_stack():
    x = np.random.RandomState(3).randn(2, 6, 17).astype(np.float32)
    jmod = jp.ResidualStack(channels=6, dilation=3)
    params = _init(jmod, x.transpose(0, 2, 1))
    wrapped = {"params": {"stack_0_0": params["params"], "ups_0": {}}}
    sd = state_dict_from_jax(wrapped, "melgan")
    prefix = "melgan.4."  # scale 0's first stack with one stack per scale
    port = pp.ResidualStack(channels=6, dilation=3)
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    ref = jmod.apply(params, jnp.asarray(x.transpose(0, 2, 1)))
    _close(port(torch.from_numpy(x)).detach(), np.asarray(ref).transpose(0, 2, 1))


@pytest.mark.parametrize("weight_norm", [False, True], ids=["folded", "trainable"])
def test_melgan_generator(weight_norm):
    c = np.random.RandomState(4).randn(2, 20, 7).astype(np.float32)
    jmod = jp.MelGANGenerator(**MELGAN_TINY)
    params = _init(jmod, c)
    port = pp.MelGANGenerator(**MELGAN_TINY, use_weight_norm=weight_norm).eval()
    sd = state_dict_from_jax(params, "melgan", weight_norm=weight_norm)
    port.load_state_dict(sd)
    got = port(torch.from_numpy(c)).detach()
    ref = jmod.apply(params, jnp.asarray(c))
    assert got.shape == (2, 1, 7 * 6)
    _close(got, np.asarray(ref))
    if not weight_norm:  # the reference names: the JAX converter maps them back to JAX's
        back = convert_melgan_state_dict({k: v.numpy() for k, v in sd.items()},
                                         num_scales=2, stacks=2)["params"]
        folded = state_dict_from_jax(params, "melgan")
        for k, v in state_dict_from_jax({"params": back}, "melgan").items():
            np.testing.assert_allclose(v.numpy(), folded[k].numpy(), rtol=1e-6, atol=1e-7)
    else:
        fold_weight_norm_(port)
        _close(port(torch.from_numpy(c)).detach(), np.asarray(ref))


def test_melgan_discriminators():
    x = np.random.RandomState(5).randn(2, 1, 64).astype(np.float32)
    jmod = jp.MelGANMultiScaleDiscriminator(scales=2)
    jsingle = jp.MelGANDiscriminator(**MELGAN_DISC_TINY)
    params = _init(jsingle, x)
    pp_msd = pp.MelGANMultiScaleDiscriminator(scales=1, **MELGAN_DISC_TINY)
    sd = state_dict_from_jax({"params": {"disc_0": params["params"]}}, "melgan_disc")
    pp_msd.load_state_dict(sd)
    assert "discriminators.0.layers.0.1.weight_v" in sd and "discriminators.0.layers.4.bias" in sd
    outs = pp_msd.discriminators[0](torch.from_numpy(x))
    refs = jsingle.apply(params, jnp.asarray(x))
    assert len(outs) == len(refs) == 5
    for g, r in zip(outs, refs):
        _close(g.detach(), np.asarray(r).transpose(0, 2, 1))

    mparams = _init(jmod, x)
    port = pp.MelGANMultiScaleDiscriminator(scales=2)
    port.load_state_dict(state_dict_from_jax(mparams, "melgan_disc"))
    for got, ref in zip(port(torch.from_numpy(x)), jmod.apply(mparams, jnp.asarray(x))):
        for g, r in zip(got, ref):
            _close(g.detach(), np.asarray(r).transpose(0, 2, 1))


def test_pqmf():
    np.testing.assert_array_equal(pp.design_prototype_filter(), jp.design_prototype_filter())
    x = np.random.RandomState(6).randn(2, 1, 256).astype(np.float32)
    port, ref = pp.PQMF(), jp.PQMF()
    assert port.state_dict() == {}  # constants only
    sub = port.analysis(torch.from_numpy(x))
    _close(sub, ref.analysis(jnp.asarray(x)), 1e-5)
    assert sub.shape == (2, 4, 64)
    back = port.synthesis(sub)
    _close(back, ref.synthesis(jnp.asarray(sub.numpy())), 1e-5)
    assert back.shape == x.shape
    with pytest.raises(ValueError, match="even"):
        pp.design_prototype_filter(61)
