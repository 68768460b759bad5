"""The port's ``AudioLDM.generate_batch`` (best-of-N generation reranked by
CLAP, ``versband_tpu_torch/models/ldm_variants.py``) against
``versband_tpu/models/ldm_variants.py`` (fp32, CPU): the chosen rows exact
on a contrived similarity matrix, the global outlier clip, and one run end
to end at tiny widths from JAX's draws.
"""

from types import SimpleNamespace

import jax
import numpy as np
import torch

from versband_tpu.models import ldm_variants as jl
from versband_tpu.models.autoencoder import AutoencoderKL as JVAE
from versband_tpu.models.dit import BandMoeDiT as JDiT
from versband_tpu.vocoder.hifigan import HifiGanGenerator as JGen
from versband_tpu_torch.models import ldm_variants as tl
from versband_tpu_torch.vocoder.hifigan import HifiGanGenerator
from torch_port_helpers import (BERT_TINY, CLAP_TINY, DIT_TINY, VAE_TINY, VOC_TINY, dit_inputs,
                                jax_context, perturb_zero_init, to_jax, torch_context,
                                write_bert_dir)

T_STEPS = 50


def _err(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max())


def test_audioldm_best_of_n_rerank_picks_the_interleaved_rows():
    """tests/test_ldm_variants.py:260 on the port: candidates tiled along the
    batch, the rows chosen by i + argmax(sims[i::B, i]) * B."""
    Bc, C, Tl, N = 2, 2, 8, 3
    ldm = tl.AudioLDM(unet_config=None, first_stage_config=None, cond_stage_config=None,
                      mel_dim=C, mel_length=Tl, timesteps=T_STEPS, scale_by_std=False,
                      scale_factor=1.0, device="cpu")
    ldm.model = lambda x, t, c: (x * 0.1, 0.0)
    ldm.first_stage = SimpleNamespace(decode=lambda z: z)
    recorded = []

    def vocoder_fn(mel):
        w = mel.reshape(mel.shape[0], -1)
        recorded.append(w)
        return w

    sims = np.zeros((Bc * N, Bc))
    sims[4, 0] = 1.0
    sims[3, 1] = 1.0
    clap = SimpleNamespace(get_audio_embeddings=lambda w: w, get_text_embeddings=lambda t: t,
                           compute_similarity=lambda a, t: sims)
    trace = {}
    out = ldm.generate_batch(torch.ones(Bc, 2, 4), ["a", "b"], vocoder_fn, clap,
                             torch.Generator().manual_seed(0), n_candidates=N, ddim_steps=5,
                             eta=0.0, trace=trace)
    assert out.shape == (Bc, C * Tl) and recorded[0].shape == (Bc * N, C * Tl)
    np.testing.assert_array_equal(out[0], recorded[0][4].numpy())
    np.testing.assert_array_equal(out[1], recorded[0][3].numpy())
    assert trace["best_index"] == [4, 3]


def test_audioldm_clips_runaway_latents_over_the_whole_batch():
    """The clip to [-10, 10] is decided by the max over every row
    (``audioldm.py:699-701``): one runaway row clips the others too."""
    ldm = tl.AudioLDM(unet_config=None, first_stage_config=None, cond_stage_config=None,
                      mel_dim=1, mel_length=2, timesteps=T_STEPS, scale_by_std=False,
                      scale_factor=1.0, device="cpu")
    ldm.model = lambda x, t, c: (torch.zeros_like(x), 0.0)
    ldm.first_stage = SimpleNamespace(decode=lambda z: z)
    x_T = torch.tensor([[[200.0, 30.0]], [[-50.0, 1.0]]])
    out = ldm.generate_batch(torch.ones(2, 1), ["a", "b"], lambda m: m.reshape(2, -1), None,
                             n_candidates=1, ddim_steps=1, eta=0.0, x_T=x_T)
    ac = ldm.schedule.alphas_cumprod[1]  # one DDIM step from t = 1 with eps 0
    scale = float(np.sqrt(ldm.schedule.alphas_cumprod[0]) / np.sqrt(ac))
    np.testing.assert_allclose(out, np.clip(x_T.numpy().reshape(2, -1) * scale, -10, 10),
                               rtol=1e-6)


def test_audioldm_generate_batch_matches_jax(tmp_path):
    """End to end at tiny widths: DiT, VAE, HiFi-GAN and CLAP (BERT tower from
    one directory for both), DDIM with CFG and eta 1 from JAX's draws. The
    latents, the candidates' waveforms and CLAP embeddings, the similarities
    (relative to their largest) and the chosen waveforms at 5e-4; the chosen
    rows equal."""
    from versband_tpu.text.clap import CLAP as JCLAP
    from versband_tpu.utils.torch_convert import convert_state_dict
    from versband_tpu_torch.text.clap import CLAP

    bert_dir = write_bert_dir(tmp_path / "bert", BERT_TINY)
    clap = CLAP(text_model=str(bert_dir), device="cpu", **CLAP_TINY)
    for name, p in clap.named_parameters():  # the BERT stays the directory's
        if not name.startswith("caption_encoder.base."):
            p.data.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
                        * 0.05)
    jclap = JCLAP(text_model=str(bert_dir), **CLAP_TINY)
    jclap.load_converted(convert_state_dict(
        {k: v.numpy() for k, v in clap.state_dict().items()
         if not k.startswith("caption_encoder.base.")}, "clap"))

    Bc, N, t_mel = 2, 3, 32
    torch.manual_seed(0)
    kw = dict(mel_dim=4, mel_length=t_mel // 2, timesteps=T_STEPS, scale_by_std=False,
              scale_factor=0.8)
    ldm = tl.AudioLDM(unet_config=dict(target="versband_tpu.models.dit.BandMoeDiT",
                                       params=DIT_TINY),
                      first_stage_config=dict(target="ldm.models.autoencoder1d.AutoencoderKL",
                                              params=VAE_TINY), device="cpu", **kw)
    perturb_zero_init(ldm.model, 1)
    voc_kw = dict(VOC_TINY, upsample_initial_channel=256, resblock_kernel_sizes=(3, 5))
    voc = HifiGanGenerator(**voc_kw).eval()
    jldm = jl.AudioLDM(unet_config=None, first_stage_config=None, cond_stage_config=None, **kw)
    jldm.model = JDiT(**DIT_TINY)
    jdecode = jax.jit(JVAE(**VAE_TINY).apply, static_argnames="method")
    jlatents = []

    def jfirst_stage(p, z, method=None):
        jlatents.append(np.asarray(z))  # the latents over scale_factor
        return jdecode(p, z, method=method)

    jldm.first_stage = SimpleNamespace(apply=jfirst_stage)
    jvoc = jax.jit(JGen(**voc_kw, use_weight_norm=False).apply)
    voc_params = to_jax(voc, "hifigan", num_resblock_kernels=2)
    jwaves = []

    def jvocoder(mel):
        w = np.asarray(jvoc(voc_params, mel))
        jwaves.append(w)
        return w

    rng = np.random.RandomState(5)
    _, _, midi, beats, cap = dit_inputs(rng, Bc, t_mel, DIT_TINY["ori_dim"], 4)
    _, _, u_midi, u_beats, u_cap = dit_inputs(rng, Bc, t_mel, DIT_TINY["ori_dim"], 4)
    captions = ["a calm piano", "loud drums and bass"]
    key = jax.random.PRNGKey(12)
    jout = jldm.generate_batch(
        to_jax(ldm.model, "dit"), to_jax(ldm.first_stage, "vae"), jax_context(midi, beats, cap),
        captions, jvocoder, jclap, key, uncond=jax_context(u_midi, u_beats, u_cap),
        guidance_scale=2.0, n_candidates=N, ddim_steps=5, eta=1.0)
    shape = (Bc * N, 4, t_mel // 2)
    k_init, k_loop = jax.random.split(key)
    draws = [np.asarray(jax.random.normal(jax.random.fold_in(k_loop, i), shape))
             for i in range(5)]
    trace = {}
    with torch.no_grad():
        out = ldm.generate_batch(
            torch_context(midi, beats, cap), captions, voc, clap,
            uncond=torch_context(u_midi, u_beats, u_cap), guidance_scale=2.0, n_candidates=N,
            ddim_steps=5, eta=1.0, trace=trace,
            x_T=torch.from_numpy(np.asarray(jax.random.normal(k_init, shape))),
            noise=lambda i: torch.from_numpy(draws[i]))
    jemb = np.asarray(jclap.get_audio_embeddings(jwaves[0]))
    jsims = np.asarray(jclap.compute_similarity(jemb, jclap.get_text_embeddings(captions)))
    jbest = [i + int(np.argmax(jsims[i::Bc, i])) * Bc for i in range(Bc)]
    assert trace["best_index"] == jbest
    assert _err(trace["audio_emb"], jemb) < 5e-4
    assert _err(trace["sims"], jsims) < 5e-4 * np.abs(jsims).max()
    assert _err(trace["samples"] / kw["scale_factor"], jlatents[0]) < 5e-4
    assert _err(trace["waveform"], jwaves[0]) < 5e-4
    assert _err(out, jout) < 5e-4 and out.shape == (Bc, t_mel * 16)
    assert np.abs(out).max() > 1e-3
