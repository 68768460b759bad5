"""The port's LDM variants (``versband_tpu_torch/models/ldm_variants.py``)
against ``versband_tpu/models/ldm_variants.py`` (fp32, CPU).

Draws are JAX's, handed to the port. Bars: 5e-4 on sampled latents (the
DiT's), 1e-5 on the classifier, its guidance and the inpainting losses,
gradients within 1e-4 of each leaf's scale. ``AudioLDM`` is in
tests/test_torch_port_audioldm.py.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from versband_tpu.models import ldm_variants as jl
from versband_tpu.models.dit import BandMoeDiT as JDiT
from versband_tpu.models.schedules import DiffusionSchedule as JSchedule
from versband_tpu_torch.models import ldm_variants as tl
from versband_tpu_torch.models.dit import BandMoeDiT
from versband_tpu_torch.models.schedules import DiffusionSchedule
from versband_tpu_torch.nn.core import TimestepEmbedder
from versband_tpu_torch.utils.config import get_obj_from_str
from versband_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import (DIT_TINY, VAE_TINY, assert_grads_match, dit_inputs,
                                jax_context, perturb_zero_init, to_jax, torch_context)

T_STEPS = 50
B, T_MEL = 2, 16
SHAPE = (B, DIT_TINY["in_channels"], T_MEL // 2)


@pytest.fixture(scope="module")
def dit_setup():
    torch.manual_seed(0)
    dit = BandMoeDiT(**DIT_TINY).eval()
    perturb_zero_init(dit, 0)
    japply = jax.jit(JDiT(**DIT_TINY).apply)
    _, _, midi, beats, cap = dit_inputs(np.random.RandomState(3), B, T_MEL, DIT_TINY["ori_dim"],
                                        4)
    return dict(dit=dit, model=lambda x, t, c: dit(x, t, c), params=to_jax(dit, "dit"),
                japply=lambda p, x, t, c: japply(p, x, t, c),
                sched=DiffusionSchedule.create(T_STEPS, "linear", 0.00085, 0.012),
                jsched=JSchedule.create(T_STEPS, "linear", 0.00085, 0.012),
                ctx=torch_context(midi, beats, cap), jctx=jax_context(midi, beats, cap))


def _err(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max())


def test_the_reference_targets_build_port_objects():
    assert get_obj_from_str("ldm.models.diffusion.audioldm.LatentDiffusion") is tl.AudioLDM
    assert get_obj_from_str("ldm.models.diffusion.ddpm_audio_inpaint."
                            "LatentDiffusion_audioinpaint") is tl.LatentDiffusionInpaint
    assert get_obj_from_str("ldm.models.diffusion.ddpm_audio_order.LatentDiffusion_audio") \
        is tl.LatentDiffusionOrder
    assert get_obj_from_str("ldm.models.diffusion.classifier.NoisyLatentImageClassifier") \
        is tl.NoiseLevelClassifier


def test_wrapper_modes():
    calls = {}

    def model(x, t, context):
        calls.update(x=x, context=context)
        return x * 0.0, 0.0

    x, t = torch.zeros(1, 4, 8), torch.zeros(1)
    c, txt = torch.ones(1, 2, 8), torch.ones(1, 3, 16)
    tl.diffusion_wrapper_apply(model, x, t, None)
    assert calls["context"] is None
    tl.diffusion_wrapper_apply(model, x, t, "concat", c_concat=c)
    assert calls["x"].shape == (1, 6, 8)
    tl.diffusion_wrapper_apply(model, x, t, "concat", c_concat=[c, c])
    assert calls["x"].shape == (1, 8, 8)
    tl.diffusion_wrapper_apply(model, x, t, "crossattn", c_crossattn=txt)
    assert calls["context"] is txt
    tl.diffusion_wrapper_apply(model, x, t, "hybrid", c_concat=c, c_crossattn=txt)
    assert set(calls["context"]) == {"c_concat", "c_crossattn"}
    for mode in ("adm", "film"):
        tl.diffusion_wrapper_apply(model, x, t, mode, c_crossattn=txt)
        assert calls["context"] is txt
    with pytest.raises(NotImplementedError):
        tl.diffusion_wrapper_apply(model, x, t, "bogus")


def test_progressive_denoising_matches_jax(dit_setup):
    s = dit_setup
    key = jax.random.PRNGKey(4)
    jx, jsnaps = jl.progressive_denoising(s["japply"], s["params"], s["jsched"], SHAPE,
                                          s["jctx"], key, n_snapshots=7)
    k_init, k_loop = jax.random.split(key)
    x_T = torch.from_numpy(np.asarray(jax.random.normal(k_init, SHAPE)))
    draws = {i: np.asarray(jax.random.normal(jax.random.fold_in(k_loop, i), SHAPE))
             for i in range(T_STEPS)}
    x, snaps = tl.progressive_denoising(s["model"], s["sched"], SHAPE, s["ctx"], n_snapshots=7,
                                        x_T=x_T, noise=lambda i: torch.from_numpy(draws[i]))
    assert snaps.shape == jsnaps.shape == (7,) + SHAPE
    assert _err(x, jx) < 5e-4 and _err(snaps, jsnaps) < 5e-4


def test_inpaint_sample_matches_jax(dit_setup):
    """Each step takes two draws from its folded key: the known region's
    re-noising and the posterior noise."""
    s = dit_setup
    key = jax.random.PRNGKey(6)
    rng = np.random.RandomState(0)
    x0 = rng.randn(*SHAPE).astype(np.float32)
    mask = np.zeros(SHAPE, np.float32)
    mask[:, :, : SHAPE[2] // 2] = 1.0
    ref = jl.inpaint_sample(s["japply"], s["params"], s["jsched"], jnp.asarray(x0),
                            jnp.asarray(mask), s["jctx"], key)
    k_init, k_loop = jax.random.split(key)

    def noise(step):
        k1, k2 = jax.random.split(jax.random.fold_in(k_loop, step))
        return tuple(torch.from_numpy(np.asarray(jax.random.normal(k, SHAPE))) for k in (k1, k2))

    got = tl.inpaint_sample(s["model"], s["sched"], torch.from_numpy(x0), torch.from_numpy(mask),
                            s["ctx"], x_T=torch.from_numpy(np.asarray(
                                jax.random.normal(k_init, SHAPE))), noise=noise)
    assert _err(got, ref) < 5e-4
    np.testing.assert_array_equal(got.numpy()[:, :, :4], x0[:, :, :4])


@pytest.mark.parametrize("T", [16, 15])
def test_noise_level_classifier_and_guidance_match_jax(T):
    """SAME padding of the stride-2 convs: (1, 2) at an even length, (2, 2)
    at an odd one; ``nn.Conv1d(padding=2)`` would put the taps elsewhere."""
    clf = jl.NoiseLevelClassifier(num_classes=3, in_channels=2, hidden=16, depth=2)
    rng = np.random.RandomState(T)
    x = rng.randn(2, 2, T).astype(np.float32)
    t = np.array([10.0, 40.0], np.float32)
    params = clf.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.randn(*p.shape), p.dtype), params)
    port = tl.NoiseLevelClassifier(3, 2, 16, 2)
    port.load_state_dict(state_dict_from_jax(params, "dit"))
    ref = clf.apply(params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t))
    assert _err(got, ref) < 1e-5
    sched, jsched = (S.create(T_STEPS, "linear", 0.00085, 0.012)
                     for S in (DiffusionSchedule, JSchedule))
    eps = rng.randn(*x.shape).astype(np.float32)
    y = np.array([0, 2])
    jeps = jl.classifier_guided_eps(jnp.asarray(eps), jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(y), clf.apply, params, jsched, scale=2.0)
    with torch.no_grad():  # the guidance takes its gradient under enable_grad
        teps = tl.classifier_guided_eps(torch.from_numpy(eps), torch.from_numpy(x),
                                        torch.from_numpy(t), torch.from_numpy(y), port, sched,
                                        scale=2.0)
    assert _err(teps, jeps) < 1e-5 and _err(jeps, eps) > 1e-3


@pytest.mark.parametrize("n_in,n_out", [(8, 4), (30, 15), (31, 16), (15, 8), (7, 13), (41, 2)])
def test_resize_mask_is_jax_nearest(n_in, n_out):
    mask = np.random.RandomState(n_in).rand(2, 1, n_in).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(mask), (2, 1, n_out), method="nearest")
    got = tl.LatentDiffusionInpaint.resize_mask(torch.from_numpy(mask), n_out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_inpaint_get_input_matches_jax():
    """An odd latent length (15): the mask's nearest resize takes frames
    1, 3, 5, ... where ``F.interpolate(mode="nearest")`` takes 0, 2, 4, ..."""
    torch.manual_seed(0)
    port = tl.LatentDiffusionInpaint(first_stage_config=dict(
        target="ldm.models.autoencoder1d.AutoencoderKL", params=VAE_TINY), mel_dim=4,
        scale_by_std=False, scale_factor=0.7, timesteps=100, device="cpu")
    assert port.conditioning_key == "hybrid"
    jldm = jl.LatentDiffusionInpaint(first_stage_config=dict(
        target="versband_tpu.models.autoencoder.AutoencoderKL", params=VAE_TINY), mel_dim=4,
        scale_by_std=False, scale_factor=0.7, timesteps=100)
    T = 30
    rng = np.random.RandomState(1)
    mel = rng.randn(2, 80, T).astype(np.float32)
    mask = np.zeros((2, 1, T), np.float32)
    mask[0, :, :9] = 1.0
    mask[1, :, 4:21] = 1.0
    text = rng.randn(2, 3, 16).astype(np.float32)
    batch = {"image": mel, "masked_image": mel * (1 - mask), "mask": mask, "caption": text}
    jz, jcond = jldm.get_input(to_jax(port.first_stage, "vae"), None,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    z, cond = port.get_input({k: torch.from_numpy(v) for k, v in batch.items()})
    assert z.shape == (2, 4, 15) and cond["c_concat"].shape == (2, 5, 15)
    assert _err(z, jz) < 2e-4 and _err(cond["c_concat"], jcond["c_concat"]) < 2e-4
    np.testing.assert_array_equal(cond["c_concat"][:, -1].numpy(),
                                  np.asarray(jcond["c_concat"][:, -1]))
    torch_nearest = torch.nn.functional.interpolate(torch.from_numpy(mask), size=15)
    assert not torch.equal(torch_nearest[:, 0], cond["c_concat"][:, -1])
    np.testing.assert_array_equal(cond["c_crossattn"].numpy(), text)


class _JTinyHybridNet(fnn.Module):
    """tests/test_ldm_variants.py's backbone: concat([x, c_concat]) channels
    and the pooled text context."""

    out_ch: int
    hidden: int = 32

    @fnn.compact
    def __call__(self, x, t, context, step=0, train=False):
        from versband_tpu.nn import TimestepEmbedder as JT

        h = jnp.swapaxes(x, 1, 2)
        temb = JT(self.hidden, name="t_embedder")(t)
        ctx = fnn.Dense(self.hidden, name="ctx_proj")(context.mean(axis=1))
        h = fnn.silu(fnn.Conv(self.hidden, (3,), padding="SAME", name="in_conv")(h)
                     + temb[:, None, :] + ctx[:, None, :])
        h = fnn.silu(fnn.Conv(self.hidden, (3,), padding="SAME", name="mid_conv")(h))
        return jnp.swapaxes(fnn.Conv(self.out_ch, (3,), padding="SAME", name="out_conv")(h),
                            1, 2), 0.0


class _TinyHybridNet(nn.Module):
    def __init__(self, in_ch, ctx_dim, out_ch, hidden=32):
        super().__init__()
        self.t_embedder = TimestepEmbedder(hidden)
        self.ctx_proj = nn.Linear(ctx_dim, hidden)
        self.in_conv = nn.Conv1d(in_ch, hidden, 3, padding=1)
        self.mid_conv = nn.Conv1d(hidden, hidden, 3, padding=1)
        self.out_conv = nn.Conv1d(hidden, out_ch, 3, padding=1)

    def forward(self, x, t, context, step=0, train=False):
        h = torch.nn.functional.silu(self.in_conv(x) + self.t_embedder(t)[:, :, None]
                                     + self.ctx_proj(context.mean(dim=1))[:, :, None])
        h = torch.nn.functional.silu(self.mid_conv(h))
        return self.out_conv(h), 0.0


@pytest.mark.parametrize("parameterization", ["eps", "x0"])
def test_inpaint_p_losses_and_gradients_match_jax(parameterization):
    C, Tl = 2, 16
    kw = dict(unet_config=None, first_stage_config=None, cond_stage_config=None, mel_dim=C,
              timesteps=T_STEPS, scale_by_std=False, scale_factor=1.0,
              parameterization=parameterization, original_elbo_weight=0.3)
    jldm = jl.LatentDiffusionInpaint(**kw)
    jldm.model = _JTinyHybridNet(out_ch=C)
    port = tl.LatentDiffusionInpaint(**kw, device="cpu")
    port.model = _TinyHybridNet(2 * C + 1, 8, C)
    rng = np.random.RandomState(0)
    x0 = rng.randn(3, C, Tl).astype(np.float32)
    mask = np.zeros((3, 1, Tl), np.float32)
    mask[:, :, : Tl // 2] = 1.0
    cond_np = {"c_concat": np.concatenate([x0 * mask, mask], axis=1),
               "c_crossattn": rng.randn(3, 2, 8).astype(np.float32)}
    jcond = {k: jnp.asarray(v) for k, v in cond_np.items()}
    params = jldm.model.init(jax.random.PRNGKey(0), jnp.concatenate(
        [jnp.asarray(x0), jcond["c_concat"]], axis=1), jnp.zeros((3,)), jcond["c_crossattn"])
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.randn(*p.shape), p.dtype), params)
    port.model.load_state_dict(state_dict_from_jax(params, "dit"))
    t = np.array([0, 17, 49])
    key = jax.random.PRNGKey(9)

    def jloss(p):
        return jldm.p_losses(p, jnp.asarray(x0), jcond, jnp.asarray(t), key)

    (jl_val, jparts), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, x0.shape, jnp.float32)))
    loss, parts = port.p_losses(torch.from_numpy(x0),
                                {k: torch.from_numpy(v) for k, v in cond_np.items()},
                                torch.from_numpy(t), noise=noise)
    loss.backward()
    for k in ("loss", "loss_simple", "loss_vlb"):
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert_grads_match(port.model, jgrads, tol=1e-4)


def test_latent_diffusion_order_single_key_dispatch():
    seen = {}

    def model(x, t, context, step=0, train=False):
        seen["context"] = context
        return x, 0.0

    x, t = torch.zeros(1, 4, 8), torch.zeros(1)
    cond = {"token_embedding": torch.zeros(1, 6, 12), "orders": torch.zeros(1, 10)}
    for key, expect in (("crossattn", cond), ("concat", {"c_concat": cond})):
        ldm = tl.LatentDiffusionOrder(unet_config=None, conditioning_key=key, device="cpu")
        ldm.model = model
        ldm.apply_model(x, t, cond)
        assert seen["context"] == expect if key == "concat" else seen["context"] is cond
    ldm.apply_model(x, t, {"c_crossattn": cond})
    assert seen["context"] is cond
