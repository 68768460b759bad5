"""The port's VAE and HiFi-GAN against ``versband_tpu`` (fp32, CPU).

Weights go from the port to JAX through the JAX package's converter, which
also holds the port's parameter names to the reference checkpoints'.
Tolerance 1e-4 (fp32 convolutions, summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models.autoencoder import AutoencoderKL as JVAE
from versband_tpu.vocoder.hifigan import HifiGanGenerator as JGen
from versband_tpu_torch.models.autoencoder import AutoencoderKL
from versband_tpu_torch.utils.convert import state_dict_from_jax
from versband_tpu_torch.vocoder.hifigan import HifiGAN, HifiGanGenerator
from torch_port_helpers import VAE_TINY, VOC_TINY, to_jax

TOL = 1e-4


def _vae(seed):
    torch.manual_seed(seed)
    vae = AutoencoderKL(**VAE_TINY).eval()
    with torch.no_grad():  # GroupNorm affine params start at 1/0; vary them
        for name, p in vae.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn(p.shape))
    return vae


def test_vae_decode_and_encode():
    vae = _vae(0)
    params = to_jax(vae, "vae")
    jvae = JVAE(**VAE_TINY)
    rng = np.random.RandomState(0)
    z = rng.randn(2, 4, 8).astype(np.float32)
    with torch.no_grad():
        mel = vae.decode(torch.from_numpy(z))
    ref = jvae.apply(params, jnp.asarray(z), method="decode")
    assert mel.shape == (2, 80, 16)
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)

    x = rng.randn(2, 80, 16).astype(np.float32)
    with torch.no_grad():
        post = vae.encode(torch.from_numpy(x))
    ref_post = jvae.apply(params, jnp.asarray(x), method="encode")
    for got, want in ((post.mean, ref_post.mean), (post.logvar, ref_post.logvar),
                      (post.kl(), ref_post.kl())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(post.nll(post.mode()).numpy(),
                               np.asarray(ref_post.nll(ref_post.mode())), rtol=1e-5)


def test_hifigan_generator():
    torch.manual_seed(1)
    gen = HifiGanGenerator(**VOC_TINY).eval()
    params = to_jax(gen, "hifigan", num_resblock_kernels=2)
    mel = np.random.RandomState(1).randn(2, 80, 12).astype(np.float32)
    with torch.no_grad():
        wav = gen(torch.from_numpy(mel))
    ref = JGen(**VOC_TINY, use_weight_norm=False).apply(params, jnp.asarray(mel))
    assert wav.shape == (2, 12 * 16)
    np.testing.assert_allclose(wav.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_hifigan_weight_norm_params_fold_jax_convention():
    """A JAX generator trained with weight norm (kernel_v/kernel_g) loads into
    the port folded per output channel, as the JAX package folds it."""
    jgen = JGen(**VOC_TINY, resblock="2", use_weight_norm=True)
    mel = np.random.RandomState(2).randn(1, 80, 10).astype(np.float32)
    params = jgen.init(jax.random.PRNGKey(0), jnp.asarray(mel))
    params = jax.tree_util.tree_map_with_path(  # g away from its init value ||v||
        lambda path, a: a * 1.5 if path[-1].key.endswith("_g") else a, params)
    gen = HifiGanGenerator(**VOC_TINY, resblock="2")
    gen.load_state_dict(state_dict_from_jax(params, "hifigan"))
    with torch.no_grad():
        wav = gen(torch.from_numpy(mel))
    np.testing.assert_allclose(wav.numpy(), np.asarray(jgen.apply(params, jnp.asarray(mel))),
                               atol=TOL, rtol=TOL)


def test_hifigan_wrapper_loads_reference_checkpoint(tmp_path):
    """The runtime wrapper reads a reference-style checkpoint directory:
    config.yaml plus ``state_dict -> model_gen`` with torch weight norm."""
    cfg = ("upsample_initial_channel: 32\nupsample_rates: [4, 4]\n"
           "upsample_kernel_sizes: [8, 8]\nresblock_kernel_sizes: [3, 7]\n"
           "resblock_dilation_sizes: [[1, 3, 5], [1, 3, 5]]\n")
    (tmp_path / "config.yaml").write_text(cfg)
    torch.manual_seed(3)
    gen = HifiGanGenerator(**VOC_TINY).eval()
    wn = HifiGanGenerator(**VOC_TINY)
    wn.load_state_dict(gen.state_dict())
    for m in wn.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            torch.nn.utils.weight_norm(m)
    assert any(k.endswith("weight_g") for k in wn.state_dict())
    torch.save({"state_dict": {"model_gen": wn.state_dict()}},
               tmp_path / "model_ckpt_steps_100.ckpt")

    voc = HifiGAN(str(tmp_path), device="cpu")
    mel = np.random.RandomState(3).randn(80, 9).astype(np.float32)
    with torch.no_grad():
        ref = gen(torch.from_numpy(mel)[None]).numpy().reshape(-1)
    got = voc.vocode(mel)
    assert got.shape == (9 * 16,)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(voc(mel.T[None]), ref, atol=1e-5)  # [1, T, 80] accepted
    with pytest.raises(ValueError):
        voc.vocode(mel[None])
