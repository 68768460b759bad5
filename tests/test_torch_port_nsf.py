"""The port's HiFi-GAN NSF (``versband_tpu_torch/vocoder/nsf.py``) against
``versband_tpu.vocoder.nsf`` (fp32, CPU, tiny widths).

torch and JAX draw different numbers from one seed, so the JAX draws are
injected: ``sine_gen`` splits its key into (phase, noise) keys and draws
``uniform(k_phase, [B, 1, H+1])`` and ``normal(k_noise, [B, T, H+1])``; the
test makes the same draws from the same key and hands them to the port.
Weights come from the JAX init through ``state_dict_from_jax`` (``nsf``
family), folded (the serving form) or kept as (v, g) (the trainable form).
Bars: forwards 2e-4, the HiFi-GAN bar of docs/PARITY.md; the f0 estimate and
the denoiser exactly (both numpy / scipy, the same code).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from versband_tpu.vocoder import nsf as jn
from versband_tpu_torch.cli.generate import build_vocoder
from versband_tpu_torch.utils.checkpoint import save_npz_params
from versband_tpu_torch.utils.convert import state_dict_from_jax
from versband_tpu_torch.vocoder import nsf as pn
from versband_tpu_torch.vocoder.conv import fold_weight_norm_

TOL = 2e-4
NSF_TINY = dict(upsample_initial_channel=16, upsample_rates=(4, 4),
                upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
                resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))
H = 9  # harmonic_num 8 + the fundamental


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=TOL, rtol=TOL)


def jax_draws(key, B, T):
    """The (init_phase, noise) that JAX's ``sine_gen`` draws from ``key``."""
    k_phase, k_noise = jax.random.split(key)
    return (np.array(jax.random.uniform(k_phase, (B, 1, H))),
            np.array(jax.random.normal(k_noise, (B, T, H))))


def _f0(B, T, seed):
    rng = np.random.RandomState(seed)
    f0 = rng.uniform(100.0, 400.0, (B, T)).astype(np.float32)
    f0[:, : T // 4] = 0.0  # an unvoiced stretch
    return f0


def test_sine_gen_with_injected_draws():
    f0 = np.repeat(_f0(2, 12, 0), 40, axis=1)[..., None]  # [B, T, 1] at the sample rate
    key = jax.random.PRNGKey(3)
    phase, noise = jax_draws(key, 2, f0.shape[1])
    sines, uv = pn.sine_gen(torch.from_numpy(f0), 24000, init_phase=torch.from_numpy(phase),
                            noise=torch.from_numpy(noise))
    rs, ruv = jn.sine_gen(jnp.asarray(f0), key, 24000)
    _close(sines, rs)
    np.testing.assert_array_equal(uv.numpy(), np.asarray(ruv))


def test_sine_gen_draws_from_the_generator():
    f0 = torch.full((1, 50, 1), 220.0)
    a, _ = pn.sine_gen(f0, 24000, generator=torch.Generator().manual_seed(1))
    b, _ = pn.sine_gen(f0, 24000, generator=torch.Generator().manual_seed(1))
    c, _ = pn.sine_gen(f0, 24000, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 1e-3


def _jax_model(weight_norm):
    jm = jn.NSFHifiGanGenerator(**NSF_TINY)
    mel = np.random.RandomState(1).randn(2, 80, 9).astype(np.float32)
    f0 = _f0(2, 9, 1)
    params = jax.jit(lambda m, f: jm.init(
        {"params": jax.random.PRNGKey(0), "source": jax.random.PRNGKey(1)}, m, f,
        noise_key=jax.random.PRNGKey(2)))(jnp.asarray(mel), jnp.asarray(f0))
    port = pn.NSFHifiGanGenerator(**NSF_TINY, use_weight_norm=weight_norm).eval()
    port.load_state_dict(state_dict_from_jax(params, "nsf", weight_norm=weight_norm))
    return jm, params, port, mel, f0


@pytest.mark.parametrize("weight_norm", [False, True], ids=["folded", "trainable"])
def test_generator_with_injected_draws(weight_norm):
    jm, params, port, mel, f0 = _jax_model(weight_norm)
    key = jax.random.PRNGKey(7)
    phase, noise = jax_draws(key, 2, 9 * 16)
    with torch.no_grad():
        got = port(torch.from_numpy(mel), torch.from_numpy(f0),
                   init_phase=torch.from_numpy(phase), noise=torch.from_numpy(noise))
    ref = jm.apply(params, jnp.asarray(mel), jnp.asarray(f0), noise_key=key)
    assert got.shape == (2, 9 * 16)
    _close(got, ref)
    if weight_norm:
        assert port.ups[0].weight_g.shape == (1, 8, 1)  # per output channel
        assert "noise_convs.0.weight" in port.state_dict()  # never weight-normed
        fold_weight_norm_(port)
        with torch.no_grad():
            _close(port(torch.from_numpy(mel), torch.from_numpy(f0),
                        init_phase=torch.from_numpy(phase), noise=torch.from_numpy(noise)), ref)


def test_generator_without_f0_is_the_plain_stack():
    jm, params, port, mel, _ = _jax_model(False)
    with torch.no_grad():
        got = port(torch.from_numpy(mel))
    _close(got, jm.apply(params, jnp.asarray(mel)))


def test_estimate_f0_and_denoise_equal_jax():
    rng = np.random.RandomState(4)
    mel = (rng.randn(80, 30) - 3.0).astype(np.float32)
    mel[20, 10:] += 4.0  # a strong low band
    np.testing.assert_array_equal(pn.estimate_f0_from_mel(mel), jn.estimate_f0_from_mel(mel))
    wav = rng.randn(5000).astype(np.float32) * 0.1
    np.testing.assert_array_equal(pn.stft_denoise(wav, 0.1), jn.stft_denoise(wav, 0.1))


def _nsf_dir(tmp_path, params):
    """A checkpoint directory: config.yaml and two steps, the newer holding
    ``params``."""
    cfg = dict(audio_sample_rate=24000, resblock="1",
               **{k: np.asarray(v).tolist() for k, v in NSF_TINY.items()})
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros_like(a), params)
    save_npz_params(str(tmp_path / "model_ckpt_steps_9000.npz"), zeros)
    save_npz_params(str(tmp_path / "model_ckpt_steps_10000.npz"), params)
    return str(tmp_path)


def test_wrapper_loads_the_newest_step_and_serves(tmp_path):
    jm, params, port, _, _ = _jax_model(False)
    ckpt = _nsf_dir(tmp_path, params)
    voc = build_vocoder("nsf", ckpt, device="cpu")
    assert isinstance(voc, pn.HifiGAN_NSF) and voc.device.type == "cpu"
    for k, v in port.state_dict().items():
        torch.testing.assert_close(voc.model.state_dict()[k], v, rtol=0, atol=0)
    mel = (np.random.RandomState(5).randn(80, 70) - 2.0).astype(np.float32)
    wav = voc(mel)
    assert wav.shape == (70 * 16,) and np.isfinite(wav).all()
    # the same draws again from a fresh wrapper's generator: the same waveform
    np.testing.assert_array_equal(build_vocoder("nsf", ckpt, device="cpu")(mel), wav)
    # f0 given: the estimate is skipped; use_nsf=False: the source is
    f0 = pn.estimate_f0_from_mel(mel)
    np.testing.assert_array_equal(pn.HifiGAN_NSF(ckpt, device="cpu").spec2wav(mel, f0=f0), wav)
    plain = pn.HifiGAN_NSF(ckpt, device="cpu", use_nsf=False)(mel)
    with torch.no_grad():
        want = port(torch.from_numpy(mel)[None])[0].numpy()
    np.testing.assert_allclose(plain, want, rtol=0, atol=1e-6)
    denoised = voc.spec2wav(mel, denoise_v=0.1)
    assert denoised.shape == wav.shape and np.isfinite(denoised).all()


def test_wrapper_reads_a_reference_ckpt(tmp_path):
    """A reference Lightning-style ``.ckpt`` with torch weight norm."""
    torch.manual_seed(0)
    ref = pn.NSFHifiGanGenerator(**NSF_TINY).eval()
    sd = {}
    for k, v in ref.state_dict().items():
        if k.endswith("weight") and v.ndim == 3 and not k.startswith(("noise_convs", "ups")):
            g = v.flatten(1).norm(dim=1).reshape(-1, 1, 1) * 2.0
            sd[k + "_v"], sd[k + "_g"] = v * 3.0, g  # torch convention: norm over dims 1..
        else:
            sd[k] = v
    torch.save({"state_dict": {"model_gen": sd}}, tmp_path / "model_ckpt_steps_5.ckpt")
    voc = pn.HifiGAN_NSF(str(tmp_path), device="cpu", **NSF_TINY)
    for k, v in ref.state_dict().items():
        w = voc.model.state_dict()[k]
        scale = 2.0 if (k + "_g") in sd else 1.0
        torch.testing.assert_close(w, v * scale, rtol=1e-5, atol=1e-6)


def test_wrapper_without_a_checkpoint_is_seeded():
    a = pn.HifiGAN_NSF(device="cpu", seed=3, **NSF_TINY)
    b = pn.HifiGAN_NSF(device="cpu", seed=3, **NSF_TINY)
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="one mel"):
        a.vocode(np.zeros((1, 80, 4), np.float32))
