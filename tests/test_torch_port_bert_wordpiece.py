"""The port's BERT (``versband_tpu_torch/text/bert.py``), its WordPiece
reader (``text/tokenizer.py``) and the CLAP caption tower
(``text/embedders.py::_FrozenBertTower``) against ``tokenizers``,
``transformers`` and the JAX package's Flax tower (fp32, CPU).

Bars: token ids equal; hidden states within 1e-5 of ``transformers``'
``BertModel`` and 1e-4 of the Flax tower.
"""

import json
import warnings

import numpy as np
import pytest
import torch

from versband_tpu_torch.text import embedders as port_emb
from versband_tpu_torch.text.bert import BertModel, load_bert, read_bert_dir, save_bert_dir
from versband_tpu_torch.text.tokenizer import HashTokenizer, WordPieceTokenizer
from torch_port_helpers import BERT_TINY, train_wordpiece_tokenizer, write_bert_dir

TEXTS = [
    "", "A calm piano ballad in C major, slow tempo.", "Crème Brûlée à la CAFÉ — naïve!",
    "中文歌曲with鋼琴 and 弦乐",
    "(brackets) [x] {y} $100 #tag @me 50% a+b=c ~tilde ¿qué? «x»",
    "ΟΔΟΣ STRASSE straße", "tab\there\nnewline\r\x00nul\x07bell�repl​zw",
    "a" * 120 + " supercalifragilistic", "[CLS] an added token inside [SEP] text [MASK]",
    " ".join(["soft jazz with saxophone"] * 30)]


@pytest.mark.parametrize("lowercase,strip_accents", [(True, None), (True, False),
                                                     (False, None), (False, True)])
@pytest.mark.parametrize("max_length", [77, 12])
def test_wordpiece_ids_equal_tokenizers(tmp_path, lowercase, strip_accents, max_length):
    """Accents, CJK, punctuation, control characters, an over-long word
    (120 characters > 100), added tokens in the text, truncation and padding,
    through the call the JAX tower makes."""
    from transformers import BertTokenizerFast

    tok = train_wordpiece_tokenizer(lowercase=lowercase, strip_accents=strip_accents)
    fast = BertTokenizerFast(tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]",
                             cls_token="[CLS]", sep_token="[SEP]", mask_token="[MASK]")
    fast.save_pretrained(str(tmp_path))
    port = WordPieceTokenizer.from_file(str(tmp_path / "tokenizer.json"))
    ref = fast(TEXTS, truncation=True, max_length=max_length, padding="max_length",
               return_tensors="np")["input_ids"]
    got = port(TEXTS, max_length=max_length, truncation=True, padding="max_length")["input_ids"]
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int64
    assert (ref == tok.token_to_id("[UNK]")).any()


def test_wordpiece_from_vocab_txt_equals_transformers(tmp_path):
    """A directory with only ``vocab.txt`` (and ``tokenizer_config.json``):
    the pipeline ``transformers`` converts a slow BERT tokenizer into."""
    from transformers import BertTokenizerFast

    vocab = train_wordpiece_tokenizer().get_vocab()
    with open(tmp_path / "vocab.txt", "w", encoding="utf-8") as f:
        f.writelines(t + "\n" for t, _ in sorted(vocab.items(), key=lambda kv: kv[1]))
    for lower in (True, False):
        ref = BertTokenizerFast(vocab_file=str(tmp_path / "vocab.txt"), do_lower_case=lower)(
            TEXTS, truncation=True, max_length=40, padding="max_length")["input_ids"]
        port = WordPieceTokenizer.from_vocab_file(str(tmp_path / "vocab.txt"), lower)
        np.testing.assert_array_equal(port(TEXTS, max_length=40)["input_ids"], ref)


def test_wordpiece_longest_match_and_unknowns():
    vocab = {t: i for i, t in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "un", "##aff",
                                         "##able", "unaff", "##a"])}
    port = WordPieceTokenizer({"model": {"type": "WordPiece", "vocab": vocab,
                                         "max_input_chars_per_word": 8},
                               "pre_tokenizer": {"type": "BertPreTokenizer"}})
    assert port.model.tokenize("unaffable") == ["[UNK]"]  # 9 characters > 8
    port.model.max_chars = 100
    assert port.model.tokenize("unaffable") == ["unaff", "##able"]
    assert port.model.tokenize("unaffx") == ["[UNK]"]  # no piece covers the rest
    assert port.encode("un,un") == [4, 1, 4]


@pytest.mark.parametrize("safe", [True, False])
def test_bert_matches_transformers(tmp_path, safe):
    """``model.safetensors`` or ``pytorch_model.bin``; the pooler is dropped."""
    from transformers import BertModel as HFBert

    write_bert_dir(tmp_path, BERT_TINY, seed=1, tokenizer=None, safe_serialization=safe)
    ref_model = HFBert.from_pretrained(str(tmp_path)).eval()
    port = load_bert(str(tmp_path))
    assert not any(k.startswith("pooler") for k in port.state_dict())
    ids = np.random.RandomState(0).randint(0, BERT_TINY["vocab_size"], (3, 11))
    with torch.no_grad():
        ref = ref_model(input_ids=torch.from_numpy(ids),
                        attention_mask=torch.ones(3, 11, dtype=torch.long)).last_hidden_state
        got = port(torch.from_numpy(ids))
    assert float((got - ref).abs().max()) < 1e-5


def test_bert_reads_pretraining_names(tmp_path):
    """A ``bert.``-prefixed checkpoint with ``LayerNorm.gamma``/``beta`` and
    heads loads to the same weights."""
    torch.manual_seed(0)
    model = BertModel(BERT_TINY).init_weights(torch.Generator().manual_seed(2))
    sd = {"bert." + k.replace("LayerNorm.weight", "LayerNorm.gamma")
          .replace("LayerNorm.bias", "LayerNorm.beta"): v for k, v in model.state_dict().items()}
    sd["cls.predictions.bias"] = torch.zeros(3)
    sd["bert.embeddings.position_ids"] = torch.arange(512)[None]
    (tmp_path / "config.json").write_text(json.dumps(BERT_TINY))
    torch.save(sd, tmp_path / "pytorch_model.bin")
    back = read_bert_dir(str(tmp_path))["state_dict"]
    assert set(back) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_save_bert_dir_round_trip(tmp_path):
    from transformers import BertModel as HFBert

    model = BertModel(BERT_TINY).init_weights(torch.Generator().manual_seed(3))
    save_bert_dir(model, str(tmp_path))
    back = load_bert(str(tmp_path))
    hf = HFBert.from_pretrained(str(tmp_path)).eval()
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 211, (2, 7)))
    with torch.no_grad():
        assert torch.equal(back(ids), model(ids))
        assert float((hf(input_ids=ids).last_hidden_state - model(ids)).abs().max()) < 1e-5


def test_tower_matches_jax_flax(tmp_path):
    """The same directory through both towers: tokenizer.json, then the Flax
    ``FlaxBertModel`` (``from_pt``) and the port's BERT."""
    from versband_tpu.text.embedders import _FrozenBertTower as JTower

    write_bert_dir(tmp_path, BERT_TINY, seed=4)
    texts = TEXTS[:6]
    jt = JTower(str(tmp_path), max_length=24)
    pt = port_emb._FrozenBertTower(str(tmp_path), max_length=24, device="cpu")
    assert isinstance(pt.tokenizer, WordPieceTokenizer)
    np.testing.assert_array_equal(pt.tokenize(texts), np.asarray(jt.tokenize(texts)))
    got = pt(texts)
    ref = np.asarray(jt(texts))
    assert got.shape == (6, 24, BERT_TINY["hidden_size"])
    assert float(np.abs(got.numpy() - ref).max()) < 1e-4


def test_tower_fallbacks_follow_jax(tmp_path):
    """No directory: the FALLBACK geometry and hashed ids, as JAX. Weights
    without tokenizer files: a loud warning and hashed ids, as JAX. A
    directory whose weights cannot be read raises (JAX falls back to a
    random init there)."""
    from versband_tpu.text.embedders import _FrozenBertTower as JTower

    pt = port_emb._FrozenBertTower("missing", fallback_config=BERT_TINY, device="cpu")
    jt = JTower("missing", fallback_config=BERT_TINY)
    assert isinstance(pt.tokenizer, HashTokenizer)
    np.testing.assert_array_equal(pt.tokenize(TEXTS), jt.tokenize(TEXTS))
    assert pt(["a b"]).shape == (1, 77, 32)
    assert port_emb._FrozenBertTower.FALLBACK == JTower.FALLBACK

    write_bert_dir(tmp_path / "w", BERT_TINY, tokenizer=None)
    with pytest.warns(UserWarning, match="HashTokenizer"):
        pt = port_emb._FrozenBertTower(str(tmp_path / "w"), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = JTower(str(tmp_path / "w"))
    assert isinstance(pt.tokenizer, HashTokenizer) and type(jt.tokenizer).__name__ == \
        "HashTokenizer"

    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "config.json").write_text(json.dumps(BERT_TINY))
    with pytest.raises(FileNotFoundError):
        port_emb._FrozenBertTower(str(tmp_path / "empty"), device="cpu")


def test_tower_reads_vocab_txt_as_autotokenizer(tmp_path):
    from transformers import AutoTokenizer

    write_bert_dir(tmp_path, BERT_TINY)
    (tmp_path / "tokenizer.json").unlink()
    pt = port_emb._FrozenBertTower(str(tmp_path), max_length=30, device="cpu")
    ref = AutoTokenizer.from_pretrained(str(tmp_path))(
        TEXTS, truncation=True, max_length=30, padding="max_length")["input_ids"]
    np.testing.assert_array_equal(pt.tokenize(TEXTS), ref)


def test_fallback_init_is_berts(tmp_path):
    """Seeded: the same weights twice; the pad row of the word embeddings 0,
    LayerNorms at 1 and 0, weights N(0, 0.02^2)."""
    a = BertModel(BERT_TINY).init_weights(torch.Generator().manual_seed(0))
    b = BertModel(BERT_TINY).init_weights(torch.Generator().manual_seed(0))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    w = a.embeddings.word_embeddings.weight
    assert torch.equal(w[0], torch.zeros_like(w[0]))
    assert abs(float(a.encoder.layer[0].intermediate.dense.weight.std()) - 0.02) < 3e-3
    assert torch.equal(a.embeddings.LayerNorm.weight, torch.ones(32))


def test_export_clap_bert_directory_reads_in_both_towers(tmp_path):
    """A reference CLAP state_dict's ``caption_encoder.base.*`` written as a
    directory (geometry from the shapes, the tokenizer copied beside it):
    the port's tower and the Flax tower read it, as ``transformers`` does."""
    from transformers import BertConfig, BertModel as HFBert

    from versband_tpu.text.embedders import _FrozenBertTower as JTower
    from versband_tpu_torch.utils.convert import export_clap_bert

    tok_dir = write_bert_dir(tmp_path / "tok", BERT_TINY)
    torch.manual_seed(5)  # 64-wide heads: the width the shapes' rule reads back
    hf = HFBert(BertConfig(**dict(BERT_TINY, hidden_size=128, num_attention_heads=2))).eval()
    sd = {"caption_encoder.base." + k: v.numpy() for k, v in hf.state_dict().items()}
    sd["audio_encoder.base.fc1.weight"] = np.zeros((2, 2), np.float32)
    out = export_clap_bert(sd, str(tmp_path / "bert"), tokenizer_src=str(tok_dir))
    assert json.loads((tmp_path / "bert" / "config.json").read_text())["num_attention_heads"] == 2
    texts = TEXTS[:4]
    pt = port_emb._FrozenBertTower(out, max_length=16, device="cpu")
    jt = JTower(out, max_length=16)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(pt.tokenize(texts))).last_hidden_state
    assert float((pt(texts) - ref).abs().max()) < 1e-5
    assert float(np.abs(np.asarray(jt(texts)) - ref.numpy()).max()) < 1e-4
    with pytest.warns(UserWarning, match="tokenizer"):
        export_clap_bert(sd, str(tmp_path / "bare"))
