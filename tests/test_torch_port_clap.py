"""The port's CLAP (``versband_tpu_torch/text/clap.py``) and the CLAP-side
embedders against ``versband_tpu`` and a torch replica of the reference
(fp32, CPU).

* audio embeddings against JAX's Cnn14 tower (folded BatchNorms) at 1e-4;
* against tests/test_clap_conversion.py's replica of the reference (real
  BatchNorm statistics under the ``.pth`` names) at 1e-4, and through the
  JAX converter's ``.npz`` into ``CLAPWrapper``;
* caption embeddings, similarities and zero-shot probabilities against JAX
  over one BERT directory;
* ``ClapTextEmbedder``, ``ClapFlanEmbedder``, ``ClassEmbedder`` and
  ``SpatialRescaler``, JAX's random tables copied in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.text import clap as jclap
from versband_tpu.text import embedders as jemb
from versband_tpu.utils.torch_convert import convert_state_dict
from versband_tpu_torch.text import clap as tclap
from versband_tpu_torch.text import embedders as temb
from versband_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import BERT_TINY, CLAP_TINY, T5_TINY, write_bert_dir, write_t5_dir

CNN = CLAP_TINY["cnn_kwargs"]
SR = CNN["sample_rate"]


def _err(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max())


def _wav(n=2, length=SR // 4, seed=0):
    return np.random.RandomState(seed).randn(n, length).astype(np.float32)


def test_logmel_matches_jax():
    wav = _wav(2, 1000)
    ref = jclap._clap_logmel(jnp.asarray(wav), SR, 256, 64, 64, 50.0, 3800.0)
    got = tclap.clap_logmel(torch.from_numpy(wav), SR, 256, 64, 64, 50.0, 3800.0)
    assert got.shape == ref.shape == (2, 1 + 1000 // 64, 64)
    assert _err(got, ref) < 2e-3  # dB, float32 FFTs of two libraries


@pytest.fixture(scope="module")
def jax_audio():
    """JAX's audio tower with every parameter moved off its init."""
    enc = jclap.AudioEncoder(CLAP_TINY["d_proj"], CNN)
    params = jax.jit(enc.init)(jax.random.PRNGKey(0), jnp.zeros((1, SR // 4)))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.randn(*p.shape), p.dtype), params)
    return enc, params


def test_audio_embeddings_match_jax(jax_audio):
    enc, params = jax_audio
    port = tclap.CLAP(text_model="missing", fallback_config=BERT_TINY, device="cpu", **CLAP_TINY)
    port.load_converted({"audio_encoder": params["params"]})
    wav = _wav(3)
    ref_emb, ref_clip = enc.apply(params, jnp.asarray(wav))
    with torch.no_grad():
        emb, clip = port.audio_encoder(torch.from_numpy(wav))
    assert _err(emb, ref_emb) < 1e-4 and _err(clip, ref_clip) < 1e-4
    bn = port.audio_encoder.base.conv_block2.bn1
    assert torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))


@pytest.fixture(scope="module")
def reference_sd():
    """The reference checkpoint's state_dict, from the replica in
    tests/test_clap_conversion.py (BatchNorm statistics randomized)."""
    import test_clap_conversion as ref

    torch.manual_seed(0)
    base, audio_proj, cap_proj = ref.TCnn14(), ref.TProjection(ref.OUT_EMB, ref.D_PROJ), \
        ref.TProjection(ref.TINY_BERT["hidden_size"], ref.D_PROJ)
    for i, m in enumerate((base, audio_proj, cap_proj)):
        ref._randomize(m, i + 1)
        m.eval()
    sd = {}
    for mod, prefix in ((base, "audio_encoder.base."), (audio_proj, "audio_encoder.projection."),
                        (cap_proj, "caption_encoder.projection.")):
        sd.update({prefix + k: v for k, v in mod.state_dict().items() if k != "melW"})
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)) + 0.1)
    kw = dict(d_proj=ref.D_PROJ, cnn_kwargs=ref.CNN_KW, text_model="missing",
              fallback_config=ref.TINY_BERT)
    return base, audio_proj, cap_proj, sd, kw


def test_reference_state_dict_loads_unchanged(reference_sd):
    """The ``.pth`` names load as they are, BatchNorm statistics included;
    the audio projection's LayerNorm eps is JAX's 1e-6 (the replica's 1e-5)."""
    base, audio_proj, cap_proj, sd, kw = reference_sd
    port = tclap.CLAP(device="cpu", **kw)
    missing, unexpected = port.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.startswith("caption_encoder.base.") for k in missing)
    wav = _wav(2, 8000, seed=3)
    with torch.no_grad():
        ref = audio_proj(base(torch.from_numpy(wav))["embedding"])
        z = torch.randn(3, 32, generator=torch.Generator().manual_seed(0))
        assert _err(port.caption_encoder.projection(z), cap_proj(z)) < 1e-5
    assert _err(port.get_audio_embeddings(wav), ref) < 1e-4


def test_npz_round_trip_into_the_wrapper(reference_sd, tmp_path):
    """JAX's converter (BatchNorms folded) -> ``.npz`` -> the port's
    ``CLAPWrapper``: the same embeddings as the replica, ``logit_scale``
    kept. A file that cannot be read raises (JAX prints and goes on)."""
    from versband_tpu.utils.checkpoint import save_npz_params

    base, audio_proj, _, sd, kw = reference_sd
    npz = str(tmp_path / "clap.npz")
    save_npz_params(npz, convert_state_dict({k: v.numpy() for k, v in sd.items()}, "clap"))
    w = tclap.CLAPWrapper(model_fp=npz, device="cpu", **kw)
    wav = _wav(2, 8000, seed=4)
    with torch.no_grad():
        ref = audio_proj(base(torch.from_numpy(wav))["embedding"])
    assert _err(w.clap.get_audio_embeddings(wav), ref) < 1e-4
    assert float(w.clap.logit_scale) == pytest.approx(float(sd["logit_scale"]), abs=1e-7)
    with pytest.raises(Exception):
        bad = tmp_path / "bad.npz"
        bad.write_bytes(b"not a zip")
        tclap.CLAPWrapper(model_fp=str(bad), device="cpu", **kw)


@pytest.fixture(scope="module")
def shared_clap(tmp_path_factory):
    """One BERT directory and one set of converted weights for both packages."""
    bert_dir = write_bert_dir(tmp_path_factory.mktemp("bert"), BERT_TINY, seed=2)
    port = tclap.CLAP(text_model=str(bert_dir), device="cpu", seed=3, **CLAP_TINY)
    ref = jclap.CLAP(text_model=str(bert_dir), **CLAP_TINY)
    ref.load_converted(convert_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()
         if not k.startswith("caption_encoder.base.")}, "clap"))
    return port, ref


def test_text_embeddings_similarity_and_zero_shot_match_jax(shared_clap):
    port, ref = shared_clap
    texts = ["a calm piano", "heavy drums!", "Crème brûlée 中文"]
    assert _err(port.get_text_embeddings(texts), ref.get_text_embeddings(texts)) < 1e-4
    wav = _wav(2, 4000, seed=5)
    a, ja = port.get_audio_embeddings(wav), ref.get_audio_embeddings(wav)
    assert _err(a, ja) < 1e-4
    sims = port.compute_similarity(a, port.get_text_embeddings(texts))
    jsims = ref.compute_similarity(ja, ref.get_text_embeddings(texts))
    assert sims.shape == (2, 3) and _err(sims, jsims) < 1e-3
    w, jw = tclap.CLAPWrapper.__new__(tclap.CLAPWrapper), jclap.CLAPWrapper.__new__(
        jclap.CLAPWrapper)
    w.clap, jw.clap = port, ref
    probs = w.classify_audio(wav[0], texts)
    assert _err(probs, jw.classify_audio(wav[0], texts)) < 1e-4
    assert probs.sum() == pytest.approx(1.0, abs=1e-5)


def test_clap_text_embedder_matches_jax(shared_clap, tmp_path):
    """Every token through the caption projection (LayerNorm eps 1e-5),
    the projection from the converted ``.npz``."""
    from versband_tpu.utils.checkpoint import save_npz_params

    port, _ = shared_clap
    bert_dir = tmp_path / "bert"
    write_bert_dir(bert_dir, BERT_TINY, seed=2)
    npz = str(tmp_path / "clap.npz")
    save_npz_params(npz, convert_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()
         if not k.startswith("caption_encoder.base.")}, "clap"))
    texts = ["a calm piano", "drums"]
    kw = dict(weights_path=npz, max_length=16, text_model=str(bert_dir), d_proj=12)
    got = temb.ClapTextEmbedder(device="cpu", **kw)(texts)
    ref = jemb.ClapTextEmbedder(**kw)(texts)
    assert got.shape == (2, 16, 12) and _err(got, ref) < 1e-4
    t5_dir = tmp_path / "t5"
    write_t5_dir(t5_dir, {**T5_TINY, "d_model": 12})  # concatenated with d_proj 12
    flan = {"ori_caption": texts, "struct_caption": ["C major", "120 bpm"]}
    got = temb.ClapFlanEmbedder(t5version=str(t5_dir), device="cpu", **kw)(flan)
    ref = jemb.ClapFlanEmbedder(t5version=str(t5_dir), **kw)(flan)
    assert got.shape == (2, 32, 12) and _err(got, ref) < 1e-4


def test_projection_init_is_jaxs_distribution():
    p = temb.Projection(300, 40).init_uniform(torch.Generator().manual_seed(0))
    w = p.linear1.weight
    assert float(w.abs().max()) <= 300 ** -0.5 and float(w.abs().max()) > 0.9 * 300 ** -0.5
    assert float(p.linear2.weight.abs().max()) <= 40 ** -0.5


def test_class_embedder_matches_jax():
    ref = jemb.ClassEmbedder(8, n_classes=10, key="label")
    port = temb.ClassEmbedder(8, n_classes=10, key="label", device="cpu")
    port.table.copy_(torch.from_numpy(np.asarray(ref.table)))  # jax.random's table
    batch = {"label": np.array([3, 0, 9])}
    got = port(batch)
    assert got.shape == (3, 1, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref(batch)))
    assert abs(float(temb.ClassEmbedder(64, 100, device="cpu").table.std()) - 0.02) < 2e-3


@pytest.mark.parametrize("method,multiplier,n_stages,out_channels", [
    ("bilinear", 0.5, 1, None), ("bilinear", 0.5, 2, 5), ("linear", 0.75, 1, None),
    ("nearest", 0.5, 1, 4), ("nearest", 0.7, 2, None), ("bilinear", 2.0, 1, None)])
def test_spatial_rescaler_matches_jax(method, multiplier, n_stages, out_channels):
    """Downsampling bilinear antialiases in ``jax.image.resize``: without
    ``antialias=True`` ``F.interpolate`` is far off."""
    x = np.random.RandomState(0).randn(2, 3, 16, 12).astype(np.float32)
    ref_mod = jemb.SpatialRescaler(n_stages, method, multiplier, 3, out_channels)
    port = temb.SpatialRescaler(n_stages, method, multiplier, 3, out_channels, device="cpu")
    if out_channels is not None:
        with torch.no_grad():  # jax.random's remap, HWIO -> OIHW
            port.remap.weight.copy_(torch.from_numpy(
                np.asarray(ref_mod.remap).transpose(3, 2, 0, 1)))
    ref = np.asarray(ref_mod(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == ref.shape and _err(got, ref) < 1e-5
    if method == "bilinear" and multiplier < 1 and out_channels is None and n_stages == 1:
        plain = torch.nn.functional.interpolate(torch.from_numpy(x), size=ref.shape[-2:],
                                                mode="bilinear")
        assert _err(plain, ref) > 0.1
    with pytest.raises(NotImplementedError):
        temb.SpatialRescaler(method="bicubic", device="cpu")(torch.from_numpy(x))


def test_clap_family_maps_jax_params_onto_the_reference_names(jax_audio):
    _, params = jax_audio
    sd = state_dict_from_jax({"audio_encoder": params["params"], "logit_scale": np.float32(2.5)},
                             "clap")
    port = tclap.CLAP(text_model="missing", fallback_config=BERT_TINY, device="cpu", **CLAP_TINY)
    own = port.state_dict()
    assert set(sd) == {k for k in own if k.startswith("audio_encoder.")} | {"logit_scale"}
    for k, v in sd.items():
        assert v.shape == own[k].shape and v.dtype == own[k].dtype, k
    p = params["params"]["base"]["conv_block1"]
    np.testing.assert_allclose(
        sd["audio_encoder.base.conv_block1.bn2.weight"].numpy() / np.sqrt(1 + 1e-5),
        np.asarray(p["bn2_scale"]), rtol=1e-6)
