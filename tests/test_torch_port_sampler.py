"""The port's CFG Euler sampler and the composed serving slice against
``versband_tpu`` (fp32, CPU).

The composed test runs sample -> VAE decode -> HiFi-GAN in both packages on
the same weights, conditioning and start noise, with the bars of
tests/test_golden_e2e.py: latent MSE < 1e-5, mel MSE <= 1e-3 and waveform
max|d| < 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models.autoencoder import AutoencoderKL as JVAE
from versband_tpu.models.cfm import euler_cfg_sample as j_euler
from versband_tpu.models.dit import BandMoeDiT as JDiT
from versband_tpu.vocoder.hifigan import HifiGanGenerator as JGen
from versband_tpu_torch.models.cfm import CFM, CFMSampler, euler_cfg_sample, euler_schedule
from versband_tpu_torch.sample.pipeline import PipelinedGenerator
from versband_tpu_torch.utils.config import apply_dot_overrides, load_config
from versband_tpu_torch.vocoder.hifigan import HifiGanGenerator
from torch_port_helpers import (
    BEATS_V, DIT_TINY, MIDI_V, VAE_TINY, VOC_TINY, perturb_zero_init, to_jax)


@pytest.mark.parametrize("num_steps,t_start", [(25, 0), (25, 7), (10, 0)])
def test_schedule_matches_jax_exactly(num_steps, t_start):
    ts = jnp.linspace(0.0, 1.0, num_steps)[t_start:]
    t_int, dt = euler_schedule(num_steps, t_start)
    np.testing.assert_array_equal(t_int, np.asarray(jnp.floor(ts[:-1] * 1000)))
    np.testing.assert_array_equal(dt, np.asarray(ts[1:] - ts[:-1]))
    assert t_int.dtype == dt.dtype == np.float32


def test_euler_loop_matches_jax_on_a_linear_field():
    """A field v = t_in * 1e-3 - x * (1 + c) through both loops, CFG on. The
    schedule is exact (above); XLA fuses the field and the update (FMA), so
    the trajectories agree to float32 rounding, 1e-6 relative."""
    x0 = np.random.RandomState(0).randn(2, 3, 5).astype(np.float32)
    cond = {"caption": np.zeros((2, 1, 1), np.float32),
            "acoustic": {"midi": np.zeros((2, 1, 4), np.int32)}}
    uncond = {"caption": np.ones((2, 1, 1), np.float32),
              "acoustic": {"midi": np.ones((2, 1, 4), np.int32)}}

    def jfield(params, x, t, ctx):
        return (t[:, None, None] * 1e-3 - x * (1 + ctx["c_crossattn"])).astype(x.dtype), 0.0

    def tfield(x, t, ctx):
        return (t[:, None, None] * 1e-3 - x * (1 + ctx["c_crossattn"])).to(x.dtype), 0.0

    def jtree(d):
        return jax.tree_util.tree_map(jnp.asarray, d)

    def ttree(d):
        return {k: ttree(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in d.items()}

    ref = j_euler(jfield, None, jnp.asarray(x0), jtree(cond), jtree(uncond), 3.0)
    got = euler_cfg_sample(tfield, torch.from_numpy(x0), ttree(cond), ttree(uncond), 3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def _tiny_cfm(device="cpu"):
    cfg = dict(
        unet_config=dict(target="versband_tpu.models.dit.BandMoeDiT", params=DIT_TINY),
        first_stage_config=dict(target="ldm.models.autoencoder1d.AutoencoderKL",
                                params=VAE_TINY),
        mel_dim=4, scale_factor=1.0)
    torch.manual_seed(0)
    return CFM(**cfg, device=device)


def test_composed_slice_matches_jax():
    cfm = _tiny_cfm()
    perturb_zero_init(cfm.model, 0)
    torch.manual_seed(1)
    voc = HifiGanGenerator(**VOC_TINY).eval()

    B, t_mel = 1, 16
    rng = np.random.RandomState(7)
    z0 = rng.randn(B, 4, t_mel // 2).astype(np.float32)
    midi = rng.randint(0, MIDI_V, (B, 1, t_mel))
    beats = rng.randint(0, BEATS_V, (B, 1, t_mel))
    cap, u_cap = rng.randn(2, B, 5, 12).astype(np.float32)
    u_midi, u_beats = np.full_like(midi, 128), np.full_like(beats, 2)

    def cond(c, m, b, lib):
        return {"caption": lib(c), "acoustic": {"midi": lib(m), "beats": lib(b)}}

    sampler = CFMSampler(cfm, 25)
    z = sampler.sample_cfg(cond(cap, midi, beats, torch.from_numpy), 2.0,
                           cond(u_cap, u_midi, u_beats, torch.from_numpy),
                           x_latent=torch.from_numpy(z0))
    with torch.no_grad():
        mel = cfm.decode_first_stage(z)
        wav = voc(mel)

    jz = j_euler(JDiT(**DIT_TINY).apply, to_jax(cfm.model, "dit"), jnp.asarray(z0),
                 cond(cap, midi, beats, jnp.asarray), cond(u_cap, u_midi, u_beats, jnp.asarray),
                 guidance_scale=2.0, num_steps=25, encode_once=True)
    jmel = JVAE(**VAE_TINY).apply(to_jax(cfm.first_stage, "vae"), jz, method="decode")
    jwav = JGen(**VOC_TINY, use_weight_norm=False).apply(
        to_jax(voc, "hifigan", num_resblock_kernels=2), jmel)

    lat_mse = float(np.mean((z.numpy() - np.asarray(jz)) ** 2))
    mel_mse = float(np.mean((mel.numpy() - np.asarray(jmel)) ** 2))
    wav_max = float(np.abs(wav.numpy() - np.asarray(jwav)).max())
    assert np.abs(np.asarray(jz) - z0).max() > 1e-2  # the field moved the latent
    assert lat_mse < 1e-5, lat_mse
    assert mel_mse <= 1e-3, mel_mse
    assert wav_max < 5e-3, wav_max
    assert wav.shape == (B, t_mel * 16)


def test_config_builds_port_from_shipped_yaml():
    cfg = load_config("configs/vocal2music.yaml")
    cfg = apply_dot_overrides(cfg, [f"model.params.unet_config.params.{k}={v}" for k, v in
                                    dict(hidden_size=16, context_dim=16, num_heads=2, depth=1,
                                         num_experts=2, ori_dim=12, multiple_of=8).items()]
                              + ["model.params.first_stage_config.params.ddconfig.ch=32",
                                 "model.params.first_stage_config.params.ddconfig.ch_mult=[1,2]"])
    assert cfg.model.params.unet_config.params.use_flash is True
    from versband_tpu_torch.utils.config import instantiate_from_config
    from versband_tpu_torch.models.autoencoder import AutoencoderKL
    from versband_tpu_torch.models.dit import BandMoeDiT

    cfm = instantiate_from_config(cfg.model, device="cpu")
    assert isinstance(cfm, CFM)
    assert isinstance(cfm.model, BandMoeDiT) and isinstance(cfm.first_stage, AutoencoderKL)
    assert cfm.latent_length(1504) == 752 and cfm.latent_length(1505) == 753
    cond = {"caption": torch.randn(1, 80, 12),
            "acoustic": {"midi": torch.zeros(1, 1, 31, dtype=torch.long),
                         "beats": torch.zeros(1, 1, 31, dtype=torch.long)}}
    z = cfm.sample(cond, torch.Generator().manual_seed(0), timesteps=3)
    assert z.shape == (1, 20, 16) and torch.isfinite(z).all()


def test_entry_points_raise_without_cuda(monkeypatch):
    from versband_tpu_torch.device import resolve_device
    from versband_tpu_torch.vocoder.hifigan import HifiGAN

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _tiny_cfm(device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HifiGAN(upsample_initial_channel=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"


def test_pipelined_generator_order_and_depth():
    issued, done = [], []

    def sample(cond, gen):
        issued.append(cond)
        return torch.full((2,), float(cond))

    gen = PipelinedGenerator(sample, lambda z: z * 2, lambda mel: mel + 1, depth=2)
    for i, wav in enumerate(gen.generate((c, None) for c in range(5))):
        done.append(wav)
        # request i is collected only after request i+1 was issued (depth 2)
        assert len(issued) == min(i + 2, 5)
    assert [w.tolist() for w in done] == [[2 * c + 1.0] * 2 for c in range(5)]
    mels = list(PipelinedGenerator(sample, lambda z: z, depth=1).generate([(3, None)]))
    assert mels[0].tolist() == [3.0, 3.0]
