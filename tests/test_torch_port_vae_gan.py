"""Stage 1's VAE-GAN in the port against ``versband_tpu`` (fp32, CPU, the JAX
suite's tiny widths: ``VAE_GAN_DD`` of tests/test_vae_gan_training.py and a
PatchGAN of hidden size 8 and 2 layers).

The loss module's weights come from the JAX init (its ``params`` and
``batch_stats``, perturbed so that the BatchNorm statistics matter) through
the port's ``vaegan_loss`` family; the VAE's go from the port to JAX through
the JAX converter. The JAX step's posterior draws are recorded as it makes
them (``jax.debug.callback`` around ``jax.random.normal``; its three VAE
forwards draw the same noise) and handed to the port.

Bars: forward values 1e-5 relative to their scale (fp32 convolutions in
another order); the R1 gradient 1e-5 of its largest element; losses,
``d_weight`` and ``r1_penalty`` 1e-5 relative; after one step of Adam at LR
1e-3 every parameter, the BatchNorm statistics among them, within 5e-2 x LR
of JAX's, and ``logvar`` exactly where it was. A first Adam step moves each
element by ``LR g / (|g| + eps)``, about LR, so a gradient that differs by dg
in summation order moves it up to ``LR dg / eps`` apart: with eps 1e-3 and
fp32 gradients of up to ~70, measured 2.0e-2 x LR at most. Adam's eps is
1e-3 on both sides in the step tests, as in test_torch_port_train_golden.py:
at these widths each GroupNorm group is one channel, so the bias of every
res block's first conv is cancelled by the norm after it and its gradient is
exactly 0; what each package computes there is rounding noise, which Adam at
eps 1e-8 turns into moves of +-LR in either direction (measured: 2e-3
apart, 2 LR).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models.autoencoder import AutoencoderKL as JVAE
from versband_tpu.train import gan_losses as jgl
from versband_tpu.train.state import TrainState as JState, make_adam as j_adam
from versband_tpu.train.vae_step import make_vae_eval_step as j_eval
from versband_tpu.train.vae_step import make_vae_train_step as j_step
from versband_tpu_torch.train import gan_losses as gl
from versband_tpu_torch.train.state import TrainState, make_adam
from versband_tpu_torch.train.vae_step import make_vae_eval_step, make_vae_train_step
from versband_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import (VAE_GAN_DD, VAE_GAN_DISC as DISC, jax_loss_vars, one_draw,
                                port_loss, port_vae, record_normals, to_jax)

LR = 1e-3
REL = 1e-5
EPS = 1e-3  # Adam's eps in the step tests (see the module doc)
PARAM_TOL = 5e-2 * LR  # parameters after a step (see the module doc)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def mel_batch(seed=0, B=2, T=64) -> np.ndarray:
    return np.random.RandomState(seed).randn(B, 80, T).astype(np.float32)


@pytest.mark.parametrize("use_actnorm", [False, True], ids=["batchnorm", "actnorm"])
def test_discriminator_and_r1_gradient_match_jax(use_actnorm):
    mel = mel_batch(1)
    jl = jgl.VAEGANLoss(**DISC, use_actnorm=use_actnorm)
    v = jax_loss_vars(jl, mel)
    pl = port_loss(v, use_actnorm=use_actnorm)
    want = np.asarray(jl.apply(v, jnp.asarray(mel), method="disc_forward"))
    x = torch.from_numpy(mel).requires_grad_(True)
    got = pl.disc_forward(x)
    assert got.shape == want.shape == (2, 1, 18, 14)
    assert _rel(got.detach(), want) <= REL
    grad_want = jax.grad(lambda m: jl.apply(v, m, method="disc_forward").sum())(jnp.asarray(mel))
    grad_got, = torch.autograd.grad(got.sum(), x)
    assert _rel(grad_got, grad_want) <= REL


def test_state_dict_names_are_the_references():
    loss = gl.VAEGANLoss(disc_num_layers=3)
    names = set(loss.state_dict())
    assert {"logvar", "discriminator.main.0.weight", "discriminator.main.2.weight",
            "discriminator.main.3.running_mean", "discriminator.main.3.running_var",
            "discriminator.main.11.weight", "discriminator.main.11.bias"} <= names
    # the BatchNorm statistics are parameters of the discriminator's optimizer
    params = dict(loss.named_parameters())
    assert "discriminator.main.9.running_var" in params and "discriminator.main.2.bias" not in names


def test_nll_kl_and_g_loss_match_jax():
    mel, rec = mel_batch(2), mel_batch(3)
    moments = np.random.RandomState(4).randn(2, 8, 32).astype(np.float32)
    jl = jgl.VAEGANLoss(**DISC)
    v = jax_loss_vars(jl, mel)
    v = {**v, "params": {**v["params"], "logvar": jnp.asarray(0.3, jnp.float32)}}
    pl = port_loss(v)
    from versband_tpu.models.distributions import DiagonalGaussian as JGauss
    from versband_tpu_torch.models.distributions import DiagonalGaussian

    want = jl.apply(v, jnp.asarray(mel), jnp.asarray(rec), JGauss(jnp.asarray(moments)),
                    method="nll_kl")
    got = pl.nll_kl(torch.from_numpy(mel), torch.from_numpy(rec),
                    DiagonalGaussian(torch.from_numpy(moments)))
    for k in ("rec_loss", "nll_loss", "weighted_nll_loss", "kl_loss", "logvar"):
        assert _rel(got[k].detach(), want[k]) <= REL, k
    g_want = jl.apply(v, jnp.asarray(rec), method="g_loss")
    assert _rel(pl.g_loss(torch.from_numpy(rec)).detach(), g_want) <= REL


@pytest.mark.parametrize("kind", ["mse", "hinge", "vanilla"])
def test_d_losses_match_jax(kind):
    rng = np.random.RandomState(5)
    real, fake = rng.randn(2, 1, 6, 9).astype(np.float32), rng.randn(2, 1, 6, 9).astype(np.float32)
    want = jgl._D_LOSSES[kind](jnp.asarray(real), jnp.asarray(fake))
    got = gl.VAEGANLoss(**DISC, disc_loss=kind).d_loss(torch.from_numpy(real),
                                                       torch.from_numpy(fake))
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("step", [0, 9, 10, 11, 80001])
def test_adopt_weight_matches_jax(step):
    assert gl.adopt_weight(2.0, step, threshold=10) == float(jgl.adopt_weight(2.0, step, 10))
    assert gl.adopt_weight(2.0, step, threshold=80001, value=0.5) == \
        float(jgl.adopt_weight(2.0, step, 80001, 0.5))


@pytest.mark.parametrize("nll,g", [(3.0, 2.0), (1.0, 0.0), (5e3, 1e-5), (0.0, 1.0)])
def test_adaptive_d_weight_matches_jax_and_clamps(nll, g):
    want = float(jgl.adaptive_d_weight(jnp.float32(nll), jnp.float32(g), 0.5))
    got = gl.adaptive_d_weight(torch.tensor(nll), torch.tensor(g), 0.5)
    assert not got.requires_grad and float(got) == pytest.approx(want, rel=1e-6)
    assert 0.0 <= float(got) <= 0.5 * 1e4


def test_bad_options_raise():
    with pytest.raises(ValueError, match="perceptual"):
        gl.VAEGANLoss(perceptual_weight=1.0)
    with pytest.raises(ValueError, match="disc_loss"):
        gl.VAEGANLoss(disc_loss="wgan")


def test_make_adam_matches_optax():
    """Adam(0.5, 0.9), eps 1e-8, with accumulation over 2 micro-steps, as
    ``optax.MultiSteps(optax.adam)``: parameters within 1e-6 x LR after 4
    micro-steps."""
    import optax

    rng = np.random.RandomState(6)
    w0 = rng.randn(7).astype(np.float32)
    grads = [rng.randn(7).astype(np.float32) for _ in range(4)]
    tx = j_adam(LR, accumulate_grad_batches=2)
    params, opt = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    for g in grads:
        upd, opt = tx.update(jnp.asarray(g), opt, params)
        params = optax.apply_updates(params, upd)
    mod = torch.nn.Linear(7, 1, bias=False)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w0)[None])
    state = TrainState(mod, make_adam(LR, accumulate_grad_batches=2))
    assert state.tx.betas == (0.5, 0.9) and state.tx.weight_decay == 0.0
    for g in grads:
        mod.weight.grad = torch.from_numpy(g)[None].clone()
        state.apply_gradients()
    assert state.updates == 2
    np.testing.assert_allclose(mod.weight.detach().numpy()[0], np.asarray(params), rtol=0,
                               atol=1e-6 * LR)


def _jax_setup(disc_start, mel):
    vae = port_vae()
    jvae = JVAE(embed_dim=4, ddconfig=VAE_GAN_DD)
    jl = jgl.VAEGANLoss(disc_start=disc_start, **DISC)
    jv = jax_loss_vars(jl, mel)
    return vae, jvae, jl, jv


@pytest.mark.parametrize("disc_start,steps_before", [(1, 0), (1, 1)],
                         ids=["before_disc_start", "after_disc_start"])
def test_one_step_matches_jax(disc_start, steps_before, monkeypatch):
    """One ``make_vae_train_step`` call at generator step ``steps_before``
    (the optimizer states start there, as after that many steps; the first
    case has ``disc_factor`` 0, the second 2)."""
    mel = mel_batch(7)
    vae, jvae, jl, jv = _jax_setup(disc_start, mel)
    jgen = JState.create(to_jax(vae, "vae"), j_adam(LR, eps=EPS))
    jdisc = JState.create(jv, j_adam(LR, eps=EPS))
    jgen = jgen.replace(step=jnp.asarray(steps_before, jnp.int32))
    draws = record_normals(monkeypatch)
    jgen2, jdisc2, jm = jax.jit(j_step(jvae, jl))(jgen, jdisc, {"image": jnp.asarray(mel)},
                                                  jax.random.PRNGKey(11))
    noise = one_draw(draws)

    loss = port_loss(jv, disc_start=disc_start)
    gen, disc = TrainState(vae, make_adam(LR, eps=EPS)), TrainState(loss, make_adam(LR, eps=EPS))
    gen.step = steps_before
    m = make_vae_train_step(vae, loss)(gen, disc, {"image": torch.from_numpy(mel)},
                                       given={"posterior": noise})
    assert m["disc_factor"] == float(jm["disc_factor"]) == (2.0 if steps_before else 0.0)
    for k in ("aeloss", "discloss", "d_weight", "r1_penalty", "rec_loss", "kl_loss", "g_loss",
              "logits_real", "logits_fake"):
        assert _rel(m[k], jm[k]) <= REL, (k, float(m[k]), float(jm[k]))
    assert gen.step == steps_before + 1
    for sd, ref in ((vae.state_dict(), state_dict_from_jax(jax.device_get(jgen2.params), "vae")),
                    (loss.state_dict(),
                     state_dict_from_jax(jax.device_get(jdisc2.params), "vaegan_loss"))):
        assert set(sd) == set(ref)
        for k, p in sd.items():
            assert float((p - ref[k]).abs().max()) <= PARAM_TOL, k
    assert loss.logvar.item() == 0.0 == float(jdisc2.params["params"]["logvar"])
    # the statistics moved as JAX moved them (by gradient, not by batch averages)
    moved = (loss.discriminator.main[3].running_var.detach() - torch.tensor(
        np.array(jv["batch_stats"]["discriminator"]["norm_1"]["var"]))).abs().max()
    assert float(moved) > 0.5 * LR


def test_eval_step_matches_jax(monkeypatch):
    mel = mel_batch(8)
    vae, jvae, jl, jv = _jax_setup(0, mel)
    draws = record_normals(monkeypatch)
    want = jax.jit(j_eval(jvae, jl))(to_jax(vae, "vae"), jv, {"image": jnp.asarray(mel)},
                                     jax.random.PRNGKey(2))
    got = make_vae_eval_step(vae, port_loss(jv))({"image": torch.from_numpy(mel)},
                                                 given={"posterior": one_draw(draws)})
    assert set(got) == set(want) == {"val/rec_loss", "val/kl_loss", "val/mse"}
    for k in got:
        assert _rel(got[k], want[k]) <= REL, k


def test_the_generator_step_leaves_no_gradient_in_the_discriminator():
    mel = mel_batch(9)
    vae, _, _, jv = _jax_setup(0, mel)
    loss = port_loss(jv, disc_start=0)
    gen, disc = TrainState(vae, make_adam(LR)), TrainState(loss, make_adam(LR))
    seen = {}
    real_apply = disc.apply_gradients

    def spy():
        seen["grads"] = {k: None if p.grad is None else p.grad.clone()
                         for k, p in disc.named.items()}
        return real_apply()

    disc.apply_gradients = spy
    gen_apply = gen.apply_gradients

    def gen_spy():
        seen["disc_before"] = [p.grad for p in disc.params]
        return gen_apply()

    gen.apply_gradients = gen_spy
    make_vae_train_step(vae, loss)(gen, disc, {"image": torch.from_numpy(mel)},
                                   torch.Generator().manual_seed(0))
    assert all(g is None for g in seen["disc_before"])
    assert seen["grads"]["logvar"] is None  # no gradient: Adam leaves it at 0
    assert float(seen["grads"]["discriminator.main.3.running_mean"].abs().max()) > 0
