"""The port's vocoder GAN steps (``versband_tpu_torch/train/vocoder_step.py``)
against ``versband_tpu.train.vocoder_step`` (fp32, CPU, tiny generators).

Every weight comes from the JAX init through ``state_dict_from_jax`` in the
trainable (v, g) form (``weight_norm=True``), among them the transposed
upsampling convs whose g is per output channel; the batch is numpy from a
seed; the JAX step is jitted. After each step the updated (v, g), biases and
discriminator weights are mapped back the same way and compared.

Bars: losses 1e-5 relative; updated parameters within 5e-2 x LR of JAX's.
A first Adam step moves an element by ``LR g / (|g| + eps)``; where |g| is
rounding noise its sign is not settled and Adam at eps 1e-8 moves it by
+-LR either way, so the HiFi-GAN steps run AdamW at eps 1e-3 on both sides
(as the VAE-GAN step tests do). RAdam's first five steps are the
bias-corrected momentum, ``LR m_hat``, with no division: the PWG steps run
ParallelWaveGAN's settings (eps 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from versband_tpu.dsp.mel import MelConfig as JMelConfig, MelSpectrogram as JMel
from versband_tpu.train.state import TrainState as JState
from versband_tpu.train.state import make_adamw as j_adamw, make_radam as j_radam
from versband_tpu.train import vocoder_step as jvs
from versband_tpu.vocoder import bigvgan as jb
from versband_tpu.vocoder import discriminators as jd
from versband_tpu.vocoder import hifigan as jh
from versband_tpu.vocoder import pwg as jp
from versband_tpu_torch.dsp.mel import MelConfig, MelSpectrogram
from versband_tpu_torch.train.state import TrainState, make_adamw, make_radam
from versband_tpu_torch.train import vocoder_step as pvs
from versband_tpu_torch.utils.convert import state_dict_from_jax
from versband_tpu_torch.vocoder import bigvgan as pb
from versband_tpu_torch.vocoder import discriminators as pd
from versband_tpu_torch.vocoder import hifigan as ph
from versband_tpu_torch.vocoder import pwg as pp

REL = 1e-5
LR = 1e-3
GEN_TINY = dict(upsample_initial_channel=256, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))
MEL = dict(n_mels=16, n_fft=128, win_size=128, hop_size=16)
MRD_RES = ((64, 16, 32), (128, 32, 64))
PWG = dict(layers=6, stacks=3, residual_channels=8, gate_channels=16, skip_channels=8,
           aux_channels=20, aux_context_window=2, upsample_scales=(4, 4))
PWG_DISC = dict(layers=4, conv_channels=8)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _assert_params(module: nn.Module, jparams, family: str, tol: float):
    ref = state_dict_from_jax(jparams, family, weight_norm=True)
    got = dict(module.named_parameters())
    assert set(ref) == set(got), set(ref) ^ set(got)
    for k, v in got.items():
        err = (v.detach() - ref[k]).abs().max().item()
        assert err <= tol, (family, k, err)


def _hifigan_setup(kind: str, seed: int = 0, B: int = 2, frames: int = 12):
    rng = np.random.RandomState(seed)
    mel = rng.randn(B, 80, frames).astype(np.float32)
    t = np.arange(frames * 16) / 24000.0
    wav = (0.4 * np.sin(2 * np.pi * 330 * t)[None] + 0.1 * rng.randn(B, frames * 16))
    wav = wav.astype(np.float32)
    if kind == "hifigan":
        jgen, pgen = jh.HifiGanGenerator(**GEN_TINY), ph.HifiGanGenerator(
            **GEN_TINY, use_weight_norm=True)
        jsecond, psecond, fam2 = jd.MultiScaleDiscriminator(), pd.MultiScaleDiscriminator(), "msd"
    else:
        jgen = jb.BigVGANGenerator(**GEN_TINY, use_fused=False)
        pgen = pb.BigVGANGenerator(**GEN_TINY, use_fused=False, use_weight_norm=True)
        jsecond = jd.MultiResolutionDiscriminator(MRD_RES, 0.25)
        psecond, fam2 = pd.MultiResolutionDiscriminator(MRD_RES, 0.25), "mrd"
    jmpd, pmpd = jd.MultiPeriodDiscriminator((2, 3)), pd.MultiPeriodDiscriminator((2, 3))
    y = jnp.asarray(wav[:, None])
    gp = jax.jit(jgen.init)(jax.random.PRNGKey(seed), jnp.asarray(mel))
    if kind == "bigvgan":  # Snake parameters start at a constant; vary them
        gp = jax.tree_util.tree_map_with_path(
            lambda path, a: a + 0.1 * np.random.RandomState(len(path)).randn(*a.shape).astype(
                np.float32) if path[-1].key in ("alpha", "beta") else a, gp)
    dp = {"mpd": jax.jit(jmpd.init)(jax.random.PRNGKey(seed + 1), y, y),
          "msd": jax.jit(jsecond.init)(jax.random.PRNGKey(seed + 2), y, y)}
    pgen.load_state_dict(state_dict_from_jax(gp, kind, weight_norm=True))
    pmpd.load_state_dict(state_dict_from_jax(dp["mpd"], "mpd"))
    psecond.load_state_dict(state_dict_from_jax(dp["msd"], fam2))
    return dict(mel=mel, wav=wav, jgen=jgen, pgen=pgen, jmpd=jmpd, pmpd=pmpd, jsecond=jsecond,
                psecond=psecond, fam2=fam2, gp=gp, dp=dp)


@pytest.mark.parametrize("kind", ["hifigan", "bigvgan"])
def test_hifigan_recipe_step_matches_jax(kind):
    s = _hifigan_setup(kind)
    opt = dict(betas=(0.8, 0.99), weight_decay=0.01, eps=1e-3)
    jstep = jax.jit(jvs.make_hifigan_train_step(s["jgen"], s["jmpd"], s["jsecond"],
                                                JMel(JMelConfig(**MEL))._forward))
    gs, ds = JState.create(s["gp"], j_adamw(LR, **opt)), JState.create(s["dp"], j_adamw(LR, **opt))
    batch = {"mel": jnp.asarray(s["mel"]), "wav": jnp.asarray(s["wav"])}
    gs, ds, jm = jstep(gs, ds, batch)

    discs = nn.ModuleDict({"mpd": s["pmpd"], "msd": s["psecond"]})
    gstate = TrainState(s["pgen"], make_adamw(LR, **opt))
    dstate = TrainState(discs, make_adamw(LR, **opt))
    step = pvs.make_hifigan_train_step(s["pgen"], s["pmpd"], s["psecond"],
                                       MelSpectrogram(MelConfig(**MEL)))
    pm = step(gstate, dstate, {"mel": torch.from_numpy(s["mel"]), "wav": torch.from_numpy(s["wav"])})
    assert set(pm) == set(jm) == {"disc_loss", "gen_adv", "fm_loss", "mel_l1", "gen_loss"}
    for k in jm:
        assert _rel(pm[k], jm[k]) <= REL, (k, float(pm[k]), float(jm[k]))
    ups = s["pgen"].ups[1] if kind == "hifigan" else s["pgen"].ups[1][0]
    assert ups.weight_g.shape == (1, 64, 1)  # a transposed conv, g per C_out
    _assert_params(s["pgen"], gs.params, kind, 5e-2 * LR)
    _assert_params(s["pmpd"], ds.params["mpd"], "mpd", 5e-2 * LR)
    _assert_params(s["psecond"], ds.params["msd"], s["fam2"], 5e-2 * LR)
    for p in list(s["pgen"].parameters()) + list(discs.parameters()):
        assert p.grad is None  # consumed by the step


def test_hifigan_recipe_refuses_the_fused_generator():
    fused = pb.BigVGANGenerator(**GEN_TINY)  # use_fused=True: K4 in every activation
    with pytest.raises(ValueError, match="use_fused"):
        pvs.make_hifigan_train_step(fused, pd.MultiPeriodDiscriminator((2,)),
                                    pd.MultiResolutionDiscriminator(MRD_RES, 0.25),
                                    MelSpectrogram(MelConfig(**MEL)))
    with pytest.raises(ValueError, match="use_fused"):  # the JAX package refuses it too
        jvs.make_hifigan_train_step(jb.BigVGANGenerator(**GEN_TINY), None, None, None)
    with pytest.raises(ValueError, match="fused_inference"):
        pvs.make_pwg_train_step(pp.ParallelWaveGANGenerator(**PWG, fused_inference=True),
                                pp.ParallelWaveGANDiscriminator(**PWG_DISC))


def _pwg_setup(seed=0, B=2, frames=70):
    rng = np.random.RandomState(seed)
    mel = rng.randn(B, 20, frames + 4).astype(np.float32)
    noise = rng.randn(B, 1, frames * 16).astype(np.float32)
    t = np.arange(frames * 16) / 24000.0
    wav = (0.4 * np.sin(2 * np.pi * 220 * t)[None] + 0.1 * rng.randn(B, frames * 16))
    jgen, jdisc = jp.ParallelWaveGANGenerator(**PWG), jp.ParallelWaveGANDiscriminator(**PWG_DISC)
    gp = jax.jit(jgen.init)(jax.random.PRNGKey(seed), jnp.asarray(noise), jnp.asarray(mel))
    dp = jax.jit(jdisc.init)(jax.random.PRNGKey(seed + 1), jnp.asarray(noise))
    pgen = pp.ParallelWaveGANGenerator(**PWG, use_weight_norm=True)
    pdisc = pp.ParallelWaveGANDiscriminator(**PWG_DISC)
    pgen.load_state_dict(state_dict_from_jax(gp, "pwg", weight_norm=True))
    pdisc.load_state_dict(state_dict_from_jax(dp, "pwg_disc"))
    batch = {"mel": mel, "noise": noise, "wav": wav.astype(np.float32)}
    return jgen, jdisc, gp, dp, pgen, pdisc, batch


def test_pwg_recipe_steps_match_jax_across_the_gate():
    """3 steps with disc_start 2: the discriminator stays where it was for
    two steps (its loss times 0: a zero gradient, RAdam's m_hat 0) and moves
    on the third; RAdam's counts tick on every step on both sides."""
    jgen, jdisc, gp, dp, pgen, pdisc, batch = _pwg_setup()
    glr, dlr = 1e-4, 5e-5
    jstep = jax.jit(jvs.make_pwg_train_step(jgen, jdisc, lambda_adv=4.0, disc_start=2))
    gs = JState.create(gp, j_radam(glr, eps=1e-6))
    ds = JState.create(dp, j_radam(dlr, eps=1e-6))
    gstate = TrainState(pgen, make_radam(glr, eps=1e-6))
    dstate = TrainState(pdisc, make_radam(dlr, eps=1e-6))
    step = pvs.make_pwg_train_step(pgen, pdisc, lambda_adv=4.0, disc_start=2)
    d0 = {k: v.detach().clone() for k, v in pdisc.named_parameters()}
    jb_ = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        gs, ds, jm = jstep(gs, ds, jb_)
        pm = step(gstate, dstate, tb)
        assert set(pm) == set(jm) == {"sc_loss", "mag_loss", "gen_adv", "gen_loss", "disc_loss"}
        for k in jm:
            assert _rel(pm[k], jm[k]) <= REL, (i, k, float(pm[k]), float(jm[k]))
        _assert_params(pgen, gs.params, "pwg", 5e-2 * glr)
        _assert_params(pdisc, ds.params, "pwg_disc", 5e-2 * dlr)
        moved = max((v.detach() - d0[k]).abs().max().item() for k, v in pdisc.named_parameters())
        if i < 2:
            assert moved == 0.0, (i, moved)
            assert float(pm["gen_loss"]) == pytest.approx(float(pm["sc_loss"] + pm["mag_loss"]))
        else:
            assert moved > 0.5 * dlr
    assert gstate.step == dstate.step == 3
    assert dstate.optimizer.state[dstate.params[0]]["step"] == 3
