"""The port's ParallelWaveGAN and ``build_vocoder`` against ``versband_tpu``
(fp32, CPU).

Weights go from the port to JAX through the JAX package's converter (``pwg``
family), which also holds the port's names to the reference's. torch and JAX
draw different noise from one seed, so the noise is made with numpy (or
drawn from the port's seeded generator) and handed to both. The JAX side
runs its dense path (``fused_inference=False``), the same function as its
Pallas layers; the port runs both of its paths (fused: K5's plain version on
the CPU). Tolerance 2e-4, the vocoder bar of docs/PARITY.md.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn.utils import weight_norm

from versband_tpu.utils.torch_convert import convert_state_dict
from versband_tpu.vocoder import pwg as jp
from versband_tpu_torch.cli.generate import build_vocoder
from versband_tpu_torch.ops import fused_wavenet as fw
from versband_tpu_torch.vocoder import pwg as pp
from versband_tpu_torch.vocoder.bigvgan import VocoderBigVGAN
from versband_tpu_torch.vocoder.hifigan import HifiGAN
from torch_port_helpers import PWG_TINY

TOL = 2e-4


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=TOL, rtol=TOL)


def _randomize_upsampler(module, seed):
    """The smoothing convs start at a constant 1/(2s+1); vary them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "up_layers" in name:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return module


def _jax(module, prefix, path):
    sd = {prefix + k: v.detach().numpy() for k, v in module.state_dict().items()}
    tree = convert_state_dict(sd, "pwg")["params"]
    for p in path:
        tree = tree[p]
    return {"params": tree}


@pytest.mark.parametrize("fk", [1, 3])
def test_upsample_network(fk):
    torch.manual_seed(0)
    m = _randomize_upsampler(pp.UpsampleNetwork((2, 3), fk), 1)
    c = np.random.RandomState(0).randn(2, 7, 9).astype(np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(c)).numpy()
    ref = jp.UpsampleNetwork((2, 3), fk, use_weight_norm=False).apply(
        _jax(m, "upsample_net.upsample.", ["upsample_net", "upsample"]),
        jnp.asarray(c.transpose(0, 2, 1)))
    assert got.shape == (2, 7, 54)
    _close(got, np.asarray(ref).transpose(0, 2, 1))


def test_conv_in_upsample_network():
    torch.manual_seed(2)
    m = _randomize_upsampler(pp.ConvInUpsampleNetwork((2, 2), aux_channels=6,
                                                      aux_context_window=2), 3)
    c = np.random.RandomState(2).randn(1, 6, 12).astype(np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(c)).numpy()
    ref = jp.ConvInUpsampleNetwork((2, 2), 6, 2, use_weight_norm=False).apply(
        _jax(m, "upsample_net.", ["upsample_net"]), jnp.asarray(c.transpose(0, 2, 1)))
    assert got.shape == (1, 6, 8 * 4)
    _close(got, np.asarray(ref).transpose(0, 2, 1))


def _generator(seed, fused):
    torch.manual_seed(seed)
    return _randomize_upsampler(pp.ParallelWaveGANGenerator(**PWG_TINY, fused_inference=fused),
                                seed).eval()


def _jax_generator_out(gen, noise, mel):
    params = {"params": convert_state_dict(
        {k: v.detach().numpy() for k, v in gen.state_dict().items()}, "pwg")["params"]}
    jm = jp.ParallelWaveGANGenerator(**PWG_TINY, use_weight_norm=False)
    return np.asarray(jm.apply(params, jnp.asarray(noise), jnp.asarray(mel)))


@pytest.mark.parametrize("fused", [True, False])
def test_generator(fused):
    gen = _generator(4, fused)
    rng = np.random.RandomState(4)
    mel = rng.randn(2, 20, 14).astype(np.float32)
    noise = rng.randn(2, 1, (14 - 4) * 4).astype(np.float32)
    n = fw.LAUNCHES
    with torch.no_grad():
        wav = gen(torch.from_numpy(noise), torch.from_numpy(mel)).numpy()
    assert fw.LAUNCHES == n and wav.shape == (2, 1, 40)
    _close(wav, _jax_generator_out(gen, noise, mel))


def test_generator_fused_and_dense_agree_at_depth_30():
    """Shipped depth and dilations (1..512 over 3 stacks) at small widths."""
    torch.manual_seed(5)
    kw = dict(PWG_TINY, layers=30, stacks=3)
    gens = [pp.ParallelWaveGANGenerator(**kw, fused_inference=f).eval() for f in (True, False)]
    gens[1].load_state_dict(gens[0].state_dict())
    rng = np.random.RandomState(5)
    mel = torch.from_numpy(rng.randn(1, 20, 20).astype(np.float32))
    noise = torch.from_numpy(rng.randn(1, 1, 64).astype(np.float32))
    with torch.no_grad():
        a, b = (g(noise, mel) for g in gens)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_wrapper_draws_seeded_noise_and_pads_the_mel():
    voc = pp.ParallelWaveGAN(device="cpu", seed=7, **PWG_TINY)
    assert voc.model.fused_inference and voc.hop == 4
    mel = np.random.RandomState(7).randn(20, 9).astype(np.float32)
    got = voc(mel)
    assert got.shape == (9 * 4,)
    noise = torch.randn((1, 1, 36), generator=torch.Generator().manual_seed(7))
    padded = np.pad(mel[None], ((0, 0), (0, 0), (2, 2)), mode="edge")
    _close(got, _jax_generator_out(voc.model, noise.numpy(), padded).reshape(-1))
    assert not np.array_equal(voc.vocode(mel), got)  # the generator moves on
    with pytest.raises(ValueError):
        voc.vocode(mel[None])


def test_wrapper_loads_a_reference_checkpoint(tmp_path):
    """The parallel_wavegan library's ``checkpoint-*steps.pkl`` with
    ``model -> generator`` in the reference's names, torch weight norm on."""
    gen = _generator(8, True)
    wn = pp.ParallelWaveGANGenerator(**PWG_TINY)
    wn.load_state_dict(gen.state_dict())
    for m in wn.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)):
            weight_norm(m)
    sd = wn.state_dict()
    assert "upsample_net.upsample.up_layers.1.weight_g" in sd
    torch.save({"model": {"generator": sd, "discriminator": {}}},
               tmp_path / "checkpoint-400steps.pkl")
    voc = pp.ParallelWaveGAN(str(tmp_path), device="cpu", seed=9, **PWG_TINY)
    mel = np.random.RandomState(9).randn(20, 6).astype(np.float32)
    got = voc(mel)
    noise = torch.randn((1, 1, 24), generator=torch.Generator().manual_seed(9))
    padded = torch.nn.functional.pad(torch.from_numpy(mel)[None], (2, 2), mode="replicate")
    with torch.no_grad():
        ref = gen(noise, padded).numpy().reshape(-1)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("name,cls", [("hifigan", HifiGAN), ("bigvgan", VocoderBigVGAN),
                                      ("pwg", pp.ParallelWaveGAN)])
def test_build_vocoder_families(name, cls):
    voc = build_vocoder(name, device="cpu")
    assert isinstance(voc, cls) and voc.device.type == "cpu"
    dtype = next(voc.model.parameters()).dtype
    assert dtype == torch.float32
    mel = np.random.RandomState(0).randn(80, 2).astype(np.float32)
    wav = voc(mel)
    assert wav.shape == (2 * 320,) and np.isfinite(wav).all()


@pytest.mark.parametrize("name,key,width", [("hifigan", "upsample_initial_channel", 48),
                                            ("bigvgan", "upsample_initial_channel", 48),
                                            ("nsf", "upsample_initial_channel", 48),
                                            ("pwg", "residual_channels", 16)])
def test_build_vocoder_passes_generator_overrides(name, key, width):
    """Keyword arguments past ``dtype`` reach the wrapper's generator
    geometry, as a benchmark configuration's ``vocoder.generator`` is
    served."""

    def widths(**generator):
        voc = build_vocoder(name, device="cpu", **generator)
        return sorted({p.shape[0] for p in voc.model.parameters() if p.ndim == 3})

    ours, default = widths(**{key: width}), widths()
    assert width in ours and width not in default and ours != default


def test_build_vocoder_errors_and_default_device():
    from versband_tpu_torch.vocoder.nsf import HifiGAN_NSF

    assert isinstance(build_vocoder("nsf", device="cpu"), HifiGAN_NSF)  # ported (item 11)
    with pytest.raises(ValueError, match="unknown vocoder"):
        build_vocoder("melgan", device="cpu")
    voc = build_vocoder("hifigan", device="cpu", dtype=torch.bfloat16)
    assert voc.model.conv_pre.weight.dtype == torch.bfloat16
    if torch.cuda.is_available():
        assert build_vocoder("pwg").device.type == "cuda"
    else:  # the default is the card: no card, no silent fall back to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_vocoder("pwg")
