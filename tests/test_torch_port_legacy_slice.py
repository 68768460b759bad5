"""The legacy backbones composed as the slice runs them, against
``versband_tpu`` (fp32, CPU), both built through ``instantiate_from_config``
from the reference's targets:

* ``LatentDiffusionOrder`` (``ldm.models.diffusion.ddpm_audio_order``) over
  ``ConcatOrderDiT`` and the 1-D ``AutoencoderKL``: DDIM (S 3 over 50
  timesteps, eta 0 and 1) on the order conditioning, then the first stage's
  decode;
* ``CFM.sample_cfg`` over ``TimeFreqMoeDiT`` (``VideoFlagLargeDiT``): 3 Euler
  steps with CFG, the conditioning encoded every step (JAX's
  ``encode_once=False`` for this backbone).

JAX's draws are handed to the port (the start noise from ``split(key)[0]``,
each DDIM step's from ``fold_in(k_loop, i)``). Bar: 5e-4 max|d| on the
latents, 5e-4 on the mels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models import cfm as jcfm
from versband_tpu.models import ldm_variants as jlv
from versband_tpu.models import samplers as js
from versband_tpu_torch.models import cfm as tcfm
from versband_tpu_torch.models import ldm_variants as tlv
from versband_tpu_torch.models import samplers as ts
from versband_tpu_torch.models.concat_dit import ConcatOrderDiT
from versband_tpu_torch.models.dit_timefreq import TimeFreqMoeDiT
from versband_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_concat_dit import ORDERS, TOKEN_IDS, perturb_zeros
from test_torch_port_ddim_plms import _loop_draws
from torch_port_helpers import VAE_TINY

TOL = 5e-4
T_STEPS, B, CTX, T_LAT = 50, 2, 12, 8
ORDER_DIT = dict(target="ldm.modules.diffusionmodules.concatDiT.ConcatOrderDiT",
                 params=dict(in_channels=4, context_dim=CTX, hidden_size=32, depth=2,
                             num_heads=2, max_len=64))
VAE = dict(target="ldm.models.autoencoder1d.AutoencoderKL", params=VAE_TINY)
TIMEFREQ = dict(target="ldm.modules.diffusionmodules.flag_large_dit_moe.VideoFlagLargeDiT",
                params=dict(in_channels=4, context_dim=CTX, hidden_size=16, depth=2,
                            num_heads=2, max_len=32, num_experts=4, multiple_of=8))


def _close(got, ref, tol=TOL):
    err = float(np.abs(got.detach().numpy() - np.asarray(ref)).max())
    assert err < tol, err
    return err


@pytest.fixture(scope="module")
def order_pair():
    kw = dict(unet_config=ORDER_DIT, first_stage_config=VAE, conditioning_key="crossattn",
              timesteps=T_STEPS, scale_by_std=False, scale_factor=0.7)
    jldm = jlv.LatentDiffusionOrder(**kw)
    port = tlv.LatentDiffusionOrder(**kw, device="cpu")
    assert isinstance(port.model, ConcatOrderDiT)
    rng = np.random.RandomState(0)
    ctx = {"token_embedding": rng.randn(B, TOKEN_IDS.shape[1], CTX).astype(np.float32),
           "token_ids": TOKEN_IDS, "orders": ORDERS}
    jctx = {k: jnp.asarray(v) for k, v in ctx.items()}
    x = jnp.zeros((B, 4, T_LAT))
    params = perturb_zeros(jldm.model.init(jax.random.PRNGKey(1), x, jnp.zeros((B,)), jctx), 2)
    vparams = jldm.first_stage.init(jax.random.PRNGKey(3), jnp.zeros((1, 80, 2 * T_LAT)))
    port.model.load_state_dict(state_dict_from_jax(params, "concat_dit"))
    port.first_stage.load_state_dict(state_dict_from_jax(vparams, "vae"))
    return jldm, port, params, vparams, ctx, jctx


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_order_ldm_ddim_and_decode_match_jax(order_pair, eta):
    jldm, port, params, vparams, ctx, jctx = order_pair
    shape = (B, 4, T_LAT)
    key = jax.random.PRNGKey(11)
    japply = jax.jit(lambda p, x, t, c: jldm.apply_model(p, x, t, c))
    ref = js.DDIMSampler(japply, jldm.schedule).sample(params, shape, jctx, key, S=3, eta=eta)
    jmel = jldm.decode_first_stage(vparams, ref)
    x_T, noise = _loop_draws(key, 4, shape)
    tctx = {k: torch.from_numpy(v) for k, v in ctx.items()}
    with torch.no_grad():
        z = ts.DDIMSampler(lambda x, t, c: port.apply_model(x, t, c), port.schedule).sample(
            shape, tctx, S=3, eta=eta, x_T=x_T, noise=noise)
        mel = port.decode_first_stage(z)
    assert np.abs(np.asarray(ref) - x_T.numpy()).max() > 1e-2  # the model moved it
    _close(z, ref)
    assert mel.shape == (B, 80, 2 * T_LAT)
    _close(mel, jmel)


def test_timefreq_cfm_sample_cfg_matches_jax():
    kw = dict(unet_config=TIMEFREQ, first_stage_config=None, mel_dim=4, scale_by_std=False)
    jm = jcfm.CFM(**kw)
    port = tcfm.CFM(**kw, device="cpu")
    assert isinstance(port.model, TimeFreqMoeDiT)
    rng = np.random.RandomState(4)
    cap, ucap = (rng.randn(B, 5, CTX).astype(np.float32) for _ in range(2))
    acoustic = rng.randn(B, 20, 2 * T_LAT).astype(np.float32)
    x0 = rng.randn(B, 4, T_LAT).astype(np.float32)
    params = perturb_zeros(jm.model.init(jax.random.PRNGKey(1), jnp.asarray(x0),
                                         jnp.zeros((B,)), jnp.asarray(cap)), 5)
    port.model.load_state_dict(state_dict_from_jax(params, "dit"))

    def cond(c, lib):
        return {"caption": lib(c), "acoustic": {"acoustic": lib(acoustic)}}

    ref = jm.sample_cfg(params, cond(cap, jnp.asarray), 2.5, cond(ucap, jnp.asarray),
                        jax.random.PRNGKey(0), timesteps=4, x_latent=jnp.asarray(x0))
    calls = []
    model = port.model
    port.model = lambda x, t, c, **k: (calls.append(c), model(x, t, c, **k))[1]
    got = port.sample_cfg(cond(cap, torch.from_numpy), 2.5, cond(ucap, torch.from_numpy),
                          timesteps=4, x_latent=torch.from_numpy(x0))
    assert len(calls) == 3 and all("c_crossattn" in c for c in calls)  # encoded every step
    assert np.abs(np.asarray(ref) - x0).max() > 1e-2
    _close(got, ref)
