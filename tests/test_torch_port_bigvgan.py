"""The port's BigVGAN against ``versband_tpu`` (fp32, CPU).

The JAX side runs with ``use_fused=False``, the unfused modules, which
compute the same function as its Pallas kernel; the port runs both its
fused path (on the CPU: K4's plain version) and its unfused modules.
Weights go from the port to JAX through the JAX package's converter
(``bigvgan`` family), except for AMPBlock2, whose activation names that
converter does not map: there they go from JAX to the port through
``state_dict_from_jax``. Tolerance 2e-4, the vocoder bar of docs/PARITY.md.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn.utils import weight_norm

from versband_tpu.utils.torch_convert import convert_state_dict
from versband_tpu.vocoder import bigvgan as jb
from versband_tpu_torch.ops import fused_act1d as fa1
from versband_tpu_torch.utils.convert import state_dict_from_jax
from versband_tpu_torch.vocoder import bigvgan as pb
from torch_port_helpers import BIGVGAN_TINY, randomize_

TOL = 2e-4


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=TOL, rtol=TOL)


def _jax_params(module: torch.nn.Module, prefix: str, path, num_kernels: int = 1):
    """The module's weights as the JAX sub-tree at ``path``: keys prefixed as
    inside a generator, converted by the JAX package, then cut out."""
    sd = {prefix + k: v.detach().numpy() for k, v in module.state_dict().items()}
    tree = convert_state_dict(sd, "bigvgan", num_resblock_kernels=num_kernels)["params"]
    for p in path:
        tree = tree[p]
    return {"params": tree}


def _both(module_fn, x):
    """Port module output with use_fused True and False (same weights)."""
    outs = []
    for fused in (True, False):
        torch.manual_seed(0)
        m = randomize_(module_fn(fused), 1).eval()
        with torch.no_grad():
            outs.append(m(torch.from_numpy(x)).numpy())
    return m, outs


@pytest.mark.parametrize("variant,logscale", [("snakebeta", True), ("snake", True),
                                              ("snakebeta", False)])
def test_activation1d(variant, logscale):
    x = np.random.RandomState(0).randn(2, 6, 21).astype(np.float32)
    m, outs = _both(lambda f: pb.Activation1d(6, variant, logscale, use_fused=f), x)
    params = _jax_params(m, "activation_post.", ["activation_post"])
    ref = jb.Activation1d(6, variant, logscale, use_fused=False).apply(
        params, jnp.asarray(x.transpose(0, 2, 1)))
    for out in outs:
        _close(out, np.asarray(ref).transpose(0, 2, 1))


def test_amp_block1():
    x = np.random.RandomState(1).randn(2, 8, 30).astype(np.float32)
    m, outs = _both(lambda f: pb.AMPBlock1(8, 3, (1, 3, 5), use_fused=f), x)
    params = _jax_params(m, "resblocks.0.", ["resblocks_0_0"])
    ref = jb.AMPBlock1(8, 3, (1, 3, 5), use_weight_norm=False, use_fused=False).apply(
        params, jnp.asarray(x.transpose(0, 2, 1)))
    for out in outs:
        _close(out, np.asarray(ref).transpose(0, 2, 1))


def test_amp_block2_loads_jax_names():
    x = np.random.RandomState(2).randn(1, 8, 25).astype(np.float32)
    jm = jb.AMPBlock2(8, 3, (1, 3), use_weight_norm=False, use_fused=False)
    xt = jnp.asarray(x.transpose(0, 2, 1))
    params = jm.init(jax.random.PRNGKey(0), xt)
    params = jax.tree_util.tree_map(lambda a: a + 0.2 if a.ndim == 1 else a, params)
    sd = state_dict_from_jax({"resblocks_0_0": params["params"]}, "bigvgan")
    for fused in (True, False):
        m = pb.AMPBlock2(8, 3, (1, 3), use_fused=fused)
        m.load_state_dict({k[len("resblocks.0."):]: v for k, v in sd.items()})
        with torch.no_grad():
            out = m(torch.from_numpy(x)).numpy()
        _close(out, np.asarray(jm.apply(params, xt)).transpose(0, 2, 1))


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_generator(resblock):
    kw = dict(BIGVGAN_TINY, resblock=resblock)
    if resblock == "2":
        kw["resblock_dilation_sizes"] = ((1, 3),) * 2
    mel = np.random.RandomState(3).randn(2, 80, 9).astype(np.float32)
    jm = jb.BigVGANGenerator(**kw, use_weight_norm=False, use_fused=False)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(mel))
    params = jax.tree_util.tree_map(lambda a: a + 0.1 if a.ndim == 1 else a, params)
    ref = np.asarray(jm.apply(params, jnp.asarray(mel)))
    sd = state_dict_from_jax(params, "bigvgan")
    for fused in (True, False):
        gen = pb.BigVGANGenerator(**kw, use_fused=fused).eval()
        gen.load_state_dict(sd)
        n = fa1.LAUNCHES
        with torch.no_grad():
            wav = gen(torch.from_numpy(mel)).numpy()
        assert fa1.LAUNCHES == n and wav.shape == ref.shape == (2, 9 * 16)
        _close(wav, ref)


def test_generator_weights_from_the_port_via_the_jax_converter():
    torch.manual_seed(4)
    gen = randomize_(pb.BigVGANGenerator(**BIGVGAN_TINY), 5).eval()
    params = {"params": convert_state_dict(
        {k: v.detach().numpy() for k, v in gen.state_dict().items()}, "bigvgan",
        num_resblock_kernels=2)["params"]}
    mel = np.random.RandomState(4).randn(1, 80, 7).astype(np.float32)
    ref = jb.BigVGANGenerator(**BIGVGAN_TINY, use_weight_norm=False, use_fused=False).apply(
        params, jnp.asarray(mel))
    with torch.no_grad():
        _close(gen(torch.from_numpy(mel)).numpy(), ref)


def test_wrapper_loads_a_reference_checkpoint(tmp_path):
    """args.yml plus ``best_netG.pt`` holding ``{"generator": state_dict}``
    with torch weight norm and the resamplers' ``filter`` buffers, in the
    reference's names; served on the CPU against JAX."""
    (tmp_path / "args.yml").write_text(
        "num_mels: 80\nupsample_initial_channel: 32\nupsample_rates: [4, 4]\n"
        "upsample_kernel_sizes: [8, 8]\nresblock: '1'\nresblock_kernel_sizes: [3, 7]\n"
        "resblock_dilation_sizes: [[1, 3, 5], [1, 3, 5]]\nactivation: snakebeta\n"
        "snake_logscale: true\n")
    torch.manual_seed(6)
    gen = randomize_(pb.BigVGANGenerator(**BIGVGAN_TINY), 7).eval()
    wn = pb.BigVGANGenerator(**BIGVGAN_TINY)
    wn.load_state_dict(gen.state_dict())
    for m in wn.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            weight_norm(m)
    sd = wn.state_dict()
    assert any(k.endswith("weight_g") for k in sd)
    taps = torch.from_numpy(fa1.kaiser_sinc_filter1d(0.25, 0.3, 12))[None, None]
    sd["resblocks.0.activations.0.upsample.filter"] = taps
    sd["resblocks.0.activations.0.downsample.lowpass.filter"] = taps
    torch.save({"generator": sd}, tmp_path / "best_netG.pt")

    voc = pb.VocoderBigVGAN(str(tmp_path), device="cpu")
    mel = np.random.RandomState(8).randn(80, 6).astype(np.float32)
    got = voc(mel)
    assert got.shape == (6 * 16,)
    with torch.no_grad():
        np.testing.assert_allclose(got, gen(torch.from_numpy(mel)[None]).numpy()[0], atol=1e-5)
    params = {"params": convert_state_dict(
        {k: v.detach().numpy() for k, v in gen.state_dict().items()}, "bigvgan",
        num_resblock_kernels=2)["params"]}
    ref = jb.BigVGANGenerator(**BIGVGAN_TINY, use_weight_norm=False, use_fused=False).apply(
        params, jnp.asarray(mel[None]))
    _close(got, np.asarray(ref)[0])


def test_wrapper_random_init_is_seeded_and_fp32():
    a = pb.VocoderBigVGAN(device="cpu", seed=3, **BIGVGAN_TINY)
    b = pb.VocoderBigVGAN(device="cpu", seed=3, **BIGVGAN_TINY)
    assert a.model.conv_pre.weight.dtype == torch.float32
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k
    assert not any(k.endswith("filter") for k in a.model.state_dict())
    mel = torch.from_numpy(np.random.RandomState(9).randn(1, 80, 5).astype(np.float32))
    assert a.waveform(mel.double()).dtype == torch.float32  # the generator casts its input
