"""The port's T5 caption tower against ``transformers`` and the JAX package.

* ``text/t5.py``'s encoder against ``FlaxT5EncoderModel`` (what the JAX tower
  runs) from a tiny ``T5Config``, ``relu`` and ``gated-gelu``, weights carried
  across by ``state_dict_from_jax(..., "t5")``: within 1e-5 (fp32, the same
  products in another order);
* the checkpoint-directory readers (``model.safetensors`` parsed by hand,
  ``pytorch_model.bin``) against ``T5EncoderModel.save_pretrained``: the
  same tensors, bit for bit, and the same hidden states;
* ``text/tokenizer.py`` against ``tokenizers`` on a Unigram model trained here
  on captions from ``CaptionGenerator2``, with a hand-built ``Precompiled``
  charsmap: identical ids on every case;
* ``TextVocalEmbedder``, ``TextVocalMusicalEmbedder`` and ``FlanT5Embedder``
  against JAX's on the same local directory (JAX loads it ``from_pt``):
  within 1e-5; ``HashTokenizer`` ids equal to JAX's.
"""

import json
import os

import numpy as np
import pytest
import torch

from versband_tpu_torch.text import embedders as port_emb
from versband_tpu_torch.text.t5 import T5Encoder, load_t5_encoder, relative_position_bucket
from versband_tpu_torch.text.tokenizer import (HashTokenizer, PrecompiledCharsmap,
                                               UnigramTokenizer, graphemes)
from versband_tpu_torch.utils.convert import state_dict_from_jax
from versband_tpu_torch.utils.safetensors_io import load_safetensors, save_safetensors
from torch_port_helpers import (CHARSMAP, T5_TINY, build_charsmap, caption_corpus,
                                train_unigram_tokenizer, write_t5_dir)

TOL = 1e-5  # fp32 encoder, port vs transformers' Flax / JAX tower
L = 80  # the shipped max_length


@pytest.fixture(scope="module")
def tokenizer():
    return train_unigram_tokenizer(caption_corpus(), charsmap=build_charsmap(CHARSMAP))


@pytest.fixture(scope="module")
def t5_dir(tmp_path_factory, tokenizer):
    d = tmp_path_factory.mktemp("t5_local")
    write_t5_dir(d, {**T5_TINY, "feed_forward_proj": "gated-gelu"}, seed=1, tokenizer=tokenizer)
    return str(d)


@pytest.mark.parametrize("proj", ["relu", "gated-gelu"])
def test_encoder_matches_flax(proj):
    from transformers import FlaxT5EncoderModel, T5Config

    cfg = {**T5_TINY, "feed_forward_proj": proj, "num_layers": 3}
    flax_model = FlaxT5EncoderModel(T5Config(**cfg), seed=3)
    port = T5Encoder(cfg)
    port.load_state_dict(state_dict_from_jax(flax_model.params, "t5"))  # strict
    ids = np.random.RandomState(0).randint(0, cfg["vocab_size"], (2, L))
    want = np.asarray(flax_model(input_ids=ids, attention_mask=np.ones_like(ids))
                      .last_hidden_state)
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_relative_position_buckets_match_transformers():
    from transformers.models.t5.modeling_t5 import T5Attention

    pos = torch.arange(200)
    rel = pos[None, :] - pos[:, None]
    want = T5Attention._relative_position_bucket(rel, bidirectional=True, num_buckets=32,
                                                 max_distance=128)
    assert torch.equal(relative_position_bucket(rel, 32, 128), want)


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "pytorch_model.bin"])
def test_checkpoint_dir_readers(tmp_path, safe):
    hf = write_t5_dir(tmp_path, {**T5_TINY, "feed_forward_proj": "gated-gelu"}, seed=2,
                      safe_serialization=safe)
    assert (tmp_path / ("model.safetensors" if safe else "pytorch_model.bin")).exists()
    port = load_t5_encoder(str(tmp_path))
    want_sd = hf.state_dict()
    for k, v in port.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (2, 24)))
    with torch.no_grad():
        torch.testing.assert_close(port(ids), hf(input_ids=ids).last_hidden_state,
                                   rtol=0, atol=1e-6)


def test_safetensors_reader_and_writer(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g),
               "b": torch.randn(7, generator=g).to(torch.float16),
               "c": torch.randn(2, 3, 4, generator=g).to(torch.bfloat16),
               "d": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "e": torch.zeros(0, 4)}
    save_file(tensors, str(tmp_path / "lib.safetensors"), metadata={"format": "pt"})
    got = load_safetensors(str(tmp_path / "lib.safetensors"))
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    save_safetensors(tensors, str(tmp_path / "port.safetensors"), {"format": "pt"})
    back = load_file(str(tmp_path / "port.safetensors"))
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


EDGE_CASES = [
    "",
    "a soft piano accompaniment",
    "   many    repeated   spaces\tand\ttabs\nand newlines   ",
    "Ｓｔyle: ﬁne ｂass ﬂute Ａ①",  # charsmap: full-width letters, ligatures, NBSP
    "unknown ÿ字 characters ✓✓ ¿qué?",
    "é Ａ́ Ａ́́ x",  # graphemes shorter and longer than 6 bytes
    "a</s>b <pad> c",  # special tokens in the text
    " ".join(caption_corpus(4, seed=5)),  # longer than max_length
    "x" * 200,
]


@pytest.mark.parametrize("max_length", [16, L])
def test_tokenizer_matches_tokenizers(tokenizer, tmp_path, max_length):
    from transformers import T5TokenizerFast

    path = tmp_path / "tokenizer.json"
    tokenizer.save(str(path))
    port = UnigramTokenizer.from_file(str(path))
    hf = T5TokenizerFast(tokenizer_object=tokenizer, eos_token="</s>", pad_token="<pad>",
                         unk_token="<unk>", extra_ids=0)
    texts = EDGE_CASES + caption_corpus(20, seed=9)
    want = hf(texts, truncation=True, max_length=max_length, padding="max_length",
              return_tensors="np")["input_ids"]
    got = port(texts, max_length=max_length, truncation=True, padding="max_length")["input_ids"]
    assert got.dtype == np.int64 and got.shape == (len(texts), max_length)
    for t, w, g in zip(texts, want, got):
        assert w.tolist() == g.tolist(), t
    assert got[0].tolist() == [1] + [0] * (max_length - 1)  # "" -> </s>, pad: CFG's uncond
    assert all(row[-1] in (0, 1) for row in got.tolist())  # </s> survives truncation


def test_precompiled_charsmap_matches_tokenizers():
    from tokenizers.normalizers import Precompiled

    blob = build_charsmap(CHARSMAP)
    ref, port = Precompiled(blob), PrecompiledCharsmap(blob)
    for s in EDGE_CASES + ["ＡＡ ﬁﬁ", "Ａ́", "́Ａ", "👍🏽ﬁ", "한국어 ﬂ", "\r\nﬁ"]:
        assert port(s) == ref.normalize_str(s), s
    assert port("Ａ́") == "A"  # a short grapheme: its shortest matching prefix only
    assert port("Ａ́́") == "Á́"  # 7 bytes: character by character


def test_graphemes():
    assert graphemes("abc") == ["a", "b", "c"]
    assert graphemes("éx") == ["é", "x"]
    assert graphemes("\r\n") == ["\r\n"]
    assert graphemes("🇩🇪🇫🇷") == ["🇩🇪", "🇫🇷"]
    assert graphemes("👨‍👩‍👧!") == ["👨‍👩‍👧", "!"]
    assert graphemes("각") == ["각"]  # Hangul L V T


@pytest.mark.parametrize("part,spec", [
    ("normalizer", {"type": "BertNormalizer"}),
    ("pre_tokenizer", {"type": "ByteLevel"}),
    ("model", {"type": "BPE", "vocab": {}, "merges": []}),
    ("post_processor", {"type": "RobertaProcessing"}),
])
def test_tokenizer_unknown_components_raise(tokenizer, part, spec):
    doc = json.loads(tokenizer.to_str())
    doc[part] = spec
    with pytest.raises(NotImplementedError, match=spec["type"]):
        UnigramTokenizer(doc)


def test_hash_tokenizer_matches_jax():
    from versband_tpu.text.embedders import HashTokenizer as JaxHash

    texts = ["", "Style: pop Musical: a calm melody in C major", "word " * 100]
    for vocab in (32128, 256):
        np.testing.assert_array_equal(HashTokenizer(vocab)(texts, 16)["input_ids"],
                                      JaxHash(vocab)(texts, 16)["input_ids"])


def _jax_caption(z):
    return np.asarray(z["caption"])


@pytest.mark.parametrize("cls", ["TextVocalEmbedder", "TextVocalMusicalEmbedder",
                                 "FlanT5Embedder"])
def test_embedders_match_jax(t5_dir, cls):
    from versband_tpu.text import embedders as jax_emb

    texts = caption_corpus(3, seed=4)
    texts[1] = ""
    if cls == "TextVocalMusicalEmbedder":
        texts = [t.replace(" Musical:", "<csep>Musical:") for t in texts]
    jm = getattr(jax_emb, cls)(version=t5_dir, max_length=24)
    pm = getattr(port_emb, cls)(version=t5_dir, max_length=24, device="cpu")
    assert isinstance(pm.tower.tokenizer, UnigramTokenizer)
    if cls == "FlanT5Embedder":
        want, got = np.asarray(jm(texts)), pm(texts).numpy()
    else:
        acoustic = {"midi": np.zeros((3, 1, 8))}
        want = _jax_caption(jm({"caption": texts, "acoustic": acoustic}))
        out = pm({"caption": texts, "acoustic": acoustic, "name": ["a", "b", "c"]})
        assert out["acoustic"] is acoustic and out["name"] == ["a", "b", "c"]
        got = out["caption"].numpy()
    assert got.shape == want.shape == (3, 48 if "Musical" in cls else 24, T5_TINY["d_model"])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(pm.tower.tokenize(texts), jm.tower.tokenize(texts))


def test_weights_without_tokenizer_warn_and_hash(tmp_path):
    from versband_tpu.text.embedders import TextVocalEmbedder as JaxEmb

    write_t5_dir(tmp_path, {**T5_TINY, "feed_forward_proj": "relu"}, seed=3)
    with pytest.warns(UserWarning, match="tokenizer"):
        pm = port_emb.TextVocalEmbedder(version=str(tmp_path), max_length=12, device="cpu")
    with pytest.warns(UserWarning, match="tokenizer"):
        jm = JaxEmb(version=str(tmp_path), max_length=12)
    assert isinstance(pm.tower.tokenizer, HashTokenizer)
    cond = {"caption": ["a calm piano", ""], "acoustic": {}}
    np.testing.assert_allclose(pm(cond)["caption"].numpy(), _jax_caption(jm(cond)),
                               rtol=0, atol=TOL)


def test_fallback_without_a_directory():
    kw = dict(version="no/such/dir", max_length=10, device="cpu",
              fallback_config={"d_model": 16, "d_ff": 32, "d_kv": 8, "num_heads": 2,
                               "num_layers": 1})
    a, b = port_emb.FlanT5Embedder(**kw), port_emb.FlanT5Embedder(**kw)
    assert isinstance(a.tower.tokenizer, HashTokenizer)
    assert a.tower.tokenizer.vocab_size == 32128  # FALLBACK's vocabulary
    za = a(["a calm melody", ""])
    assert za.shape == (2, 10, 16) and torch.isfinite(za).all()
    assert torch.equal(za, b(["a calm melody", ""]))  # the init comes from a seed
    assert not any(p.requires_grad for p in a.parameters())


def test_a_directory_without_weights_raises(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({**T5_TINY, "model_type": "t5"}))
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        port_emb.TextVocalEmbedder(version=str(tmp_path), device="cpu")
