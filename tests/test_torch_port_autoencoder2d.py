"""The port's 2-D KL and VQ autoencoders
(``versband_tpu_torch/models/autoencoder2d.py``) against
``versband_tpu/models/autoencoder2d.py`` (fp32, CPU).

Weights go JAX -> port through ``state_dict_from_jax(..., "vae")`` and, for
the KL family, back through the JAX package's ``convert_state_dict(...,
"vae")`` (its VQ codebook has no rule: see tests/test_torch_port_convert.py).
The posterior draw of a sampled forward is JAX's own ``normal(key)``, handed
to the port. Bars: the VAE's 2e-4 max|d|; VQ indices equal, its loss 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models import autoencoder2d as jae
from versband_tpu_torch.models import autoencoder2d as tae
from versband_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import to_jax

TOL = 2e-4
# attention at both encoder resolutions, a 1x1 shortcut, one downsample
DD = dict(ch=32, ch_mult=[1, 2], num_res_blocks=2, attn_resolutions=[16, 8], in_channels=1,
          resolution=16, z_channels=4, out_ch=1, double_z=True)
X = np.random.RandomState(0).randn(2, 1, 16, 12).astype(np.float32)


def _err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.fixture(scope="module")
def kl():
    jm = jae.AutoencoderKL2D(embed_dim=3, ddconfig=DD)
    params = jm.init({"params": jax.random.PRNGKey(1), "gaussian": jax.random.PRNGKey(2)},
                     jnp.asarray(X))
    m = tae.AutoencoderKL2D(embed_dim=3, ddconfig=DD).eval()
    m.load_state_dict(state_dict_from_jax(params, "vae"))
    return jm, params, m


def test_kl2d_encode_decode_match_jax(kl):
    jm, params, m = kl
    post = jm.apply(params, jnp.asarray(X), method="encode")
    rec = jm.apply(params, post.mode(), method="decode")
    with torch.no_grad():
        tpost = m.encode(torch.from_numpy(X))
        trec = m.decode(tpost.mode())
    assert tpost.mean.shape == (2, 3, 8, 6) and trec.shape == X.shape
    assert _err(tpost.mean, post.mean) < TOL and _err(tpost.logvar, post.logvar) < TOL
    assert _err(trec, rec) < TOL


def test_kl2d_sampled_forward_matches_jax(kl):
    jm, params, m = kl
    key = jax.random.PRNGKey(7)
    rec, post = jm.apply(params, jnp.asarray(X), key)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, post.mean.shape)))
    with torch.no_grad():
        trec, tpost = m(torch.from_numpy(X), noise=noise)
        mode_rec, _ = m(torch.from_numpy(X), sample_posterior=False)
    assert _err(trec, rec) < TOL
    assert _err(mode_rec, trec) > 1e-3  # the draw moved it


def test_kl2d_weights_round_trip_through_the_jax_converter(kl):
    jm, params, m = kl
    back = to_jax(m, "vae")
    ref = jm.apply(params, jnp.asarray(X), method="encode").mean
    again = jm.apply(back, jnp.asarray(X), method="encode").mean
    np.testing.assert_array_equal(np.asarray(again), np.asarray(ref))


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_encoder_decoder_match_jax(part):
    kw = {k: DD[k] for k in ("ch", "ch_mult", "num_res_blocks", "attn_resolutions", "z_channels")}
    if part == "encoder":
        jm = jae.Encoder2D(in_channels=1, resolution=16, double_z=False, **kw)
        tm = tae.Encoder2D(in_channels=1, resolution=16, double_z=False, **kw)
        x = X
    else:
        jm = jae.Decoder2D(out_ch=2, **kw)
        tm = tae.Decoder2D(out_ch=2, **kw)
        x = np.random.RandomState(1).randn(2, 4, 5, 7).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(3), jnp.moveaxis(jnp.asarray(x), 1, 3))
    ref = jnp.moveaxis(jm.apply(params, jnp.moveaxis(jnp.asarray(x), 1, 3)), 3, 1)
    sd = state_dict_from_jax({part: params["params"]}, "vae")
    tm.load_state_dict({k[len(part) + 1:]: v for k, v in sd.items()})
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.shape == ref.shape and _err(out, ref) < TOL


@pytest.fixture(scope="module")
def vq():
    jm = jae.VQModel(embed_dim=3, n_embed=8, ddconfig=DD)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(X))
    m = tae.VQModel(embed_dim=3, n_embed=8, ddconfig=DD).eval()
    m.load_state_dict(state_dict_from_jax(params, "vae"))
    return jm, params, m


def test_vq_model_matches_jax(vq):
    jm, params, m = vq
    zq, loss, idx = jm.apply(params, jnp.asarray(X), method="encode")
    rec, floss = jm.apply(params, jnp.asarray(X))
    dec = jm.apply(params, jnp.asarray(np.asarray(zq) + 0.01), method="decode")
    with torch.no_grad():
        tzq, tloss, tidx = m.encode(torch.from_numpy(X))
        trec, tfloss = m(torch.from_numpy(X))
        tdec = m.decode(tzq + 0.01)
    assert tidx.shape == (2, 8, 6) and len(np.unique(np.asarray(idx))) > 1
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    assert _err(tzq, zq) < TOL and _err(trec, rec) < TOL and _err(tdec, dec) < TOL
    assert abs(float(tloss) - float(loss)) < 1e-6 and abs(float(tfloss) - float(floss)) < 1e-6


def test_vq_interface_matches_jax():
    jm = jae.VQModelInterface(embed_dim=3, n_embed=8, ddconfig=DD)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(X))
    h = jm.apply(params, jnp.asarray(X), method="encode")
    dec = jm.apply(params, h, method="decode")
    m = tae.VQModelInterface(embed_dim=3, n_embed=8, ddconfig=DD).eval()
    m.load_state_dict(state_dict_from_jax(params, "vae"))
    with torch.no_grad():
        th = m.encode(torch.from_numpy(X))
        tdec = m.decode(th)
    assert th.shape == (2, 3, 8, 6)  # the latents before quantization
    assert _err(th, h) < TOL and _err(tdec, dec) < TOL


def test_vector_quantizer_loss_and_straight_through_match_jax():
    vq = jae.VectorQuantizer(n_embed=16, embed_dim=4)
    z = np.random.RandomState(2).randn(2, 3, 5, 4).astype(np.float32) * 0.1  # NHWC
    params = vq.init(jax.random.PRNGKey(1), jnp.asarray(z))
    zq, loss, idx = vq.apply(params, jnp.asarray(z))
    w = np.random.RandomState(3).randn(*z.shape).astype(np.float32)
    jg = jax.grad(lambda z: (vq.apply(params, z)[0] * w).sum() + vq.apply(params, z)[1])(
        jnp.asarray(z))

    tq = tae.VectorQuantizer(16, 4)
    tq.load_state_dict({"embedding.weight": torch.tensor(np.asarray(
        params["params"]["embedding"]))})
    zt = torch.tensor(z.transpose(0, 3, 1, 2), requires_grad=True)  # NCHW
    tzq, tloss, tidx = tq(zt)
    ((tzq * torch.from_numpy(w.transpose(0, 3, 1, 2))).sum() + tloss).backward()
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    assert abs(float(tloss) - float(loss)) < 1e-6
    assert _err(tzq.detach().permute(0, 2, 3, 1), zq) < 1e-6
    assert _err(zt.grad.permute(0, 2, 3, 1), jg) < 1e-6
    cb = tq.embedding.weight.detach()
    torch.testing.assert_close(tzq.detach().permute(0, 2, 3, 1)[0, 0, 0], cb[tidx[0, 0, 0]])


def test_vector_quantizer_ties_take_the_first_code():
    tq = tae.VectorQuantizer(4, 2)
    with torch.no_grad():
        tq.embedding.weight.copy_(torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 0.0]]))
    z = torch.tensor([[[[0.5]], [[0.5]]]])  # equidistant from codes 0, 1 and 2
    _, _, idx = tq(z)
    assert idx.item() == int(jnp.argmin(jnp.asarray([0.5, 0.5, 0.5, 0.5])))


def test_identity_first_stage():
    fs = tae.IdentityFirstStage(vq_interface=True)
    x = torch.ones(3)
    assert fs.encode(x) is x and fs.decode(x) is x and fs(x) is x
    assert fs.quantize(x)[0] is x and fs.quantize(x)[2] == [None, None, None]
    assert tae.IdentityFirstStage().quantize(x) is x
    assert jae.IdentityFirstStage(vq_interface=True).quantize(x)[2] == [None, None, None]
    fs.to(torch.float64).eval()  # builds as a first stage: no weights to move
