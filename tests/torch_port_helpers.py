"""Shared pieces of the port's parity tests (tests/test_torch_port_*.py).

Inputs are made with numpy from a seed and handed to both packages; weights
go from the port to JAX through the JAX package's own converter
(``versband_tpu.utils.torch_convert.convert_state_dict``) or from JAX to the
port through ``versband_tpu_torch.utils.convert.state_dict_from_jax``.
"""

import numpy as np
import torch

from versband_tpu.utils.torch_convert import convert_state_dict
from versband_tpu_torch.utils.convert import state_dict_from_jax

MIDI_V, BEATS_V = 130, 3

# tiny geometries (the JAX suite's own tiny cases)
DIT_TINY = dict(in_channels=4, context_dim=16, hidden_size=16, depth=2, num_heads=2,
                max_len=64, num_experts=2, ori_dim=12, multiple_of=8)
VAE_TINY = dict(embed_dim=4, ddconfig=dict(
    double_z=True, in_channels=80, out_ch=80, z_channels=4, kernel_size=5, ch=32,
    ch_mult=[1, 2], num_res_blocks=2, attn_layers=[0, 1], down_layers=[0], dropout=0.0))
VOC_TINY = dict(upsample_initial_channel=32, upsample_rates=(4, 4),
                upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 7),
                resblock_dilation_sizes=((1, 3, 5),) * 2)
BIGVGAN_TINY = dict(num_mels=80, **VOC_TINY)
PWG_TINY = dict(layers=6, stacks=3, residual_channels=16, gate_channels=32, skip_channels=16,
                aux_channels=20, aux_context_window=2, upsample_scales=(2, 2))


def randomize_(module: torch.nn.Module, seed: int, std: float = 0.2,
               names=("alpha", "beta")) -> torch.nn.Module:
    """Add N(0, std) to the parameters whose last name is in ``names`` (Snake
    parameters start at a constant; the comparison should not rest on it)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.rsplit(".", 1)[-1] in names:
                p.add_(torch.randn(p.shape, generator=g) * std)
    return module


def to_jax(module: torch.nn.Module, family: str, **kw):
    """The port module's weights as a JAX param tree, via the JAX converter."""
    sd = {k: v.detach().float().numpy() for k, v in module.state_dict().items()}
    return convert_state_dict(sd, family, **kw)


def load_from_jax(module: torch.nn.Module, params, wrap: str = "m",
                  prefix: str = "m.") -> torch.nn.Module:
    """Load a JAX sub-module's params into a port module of the same layout.

    The tree is nested under ``wrap`` and converted with the 'dit' family, so
    reference names (``t_embedder`` -> ``t_embedder.mlp.0``) apply; ``prefix``
    is then stripped from the keys.
    """
    sd = state_dict_from_jax({wrap: params["params"]}, "dit")
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return module


def perturb_zero_init(module: torch.nn.Module, seed: int, std: float = 0.2) -> None:
    """adaLN-zero layers and attention gates start at 0, which makes a DiT's
    output identically 0; give them random values."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "adaLN" in name or "final_layer" in name or name.endswith("gate"):
                p.copy_(torch.randn(p.shape, generator=g) * std)


def dit_inputs(rng: np.random.RandomState, B: int, t_mel: int, ori: int, in_ch: int,
               n_cap: int = 5):
    """(x, t, midi, beats, caption) numpy inputs of a DiT forward."""
    x = rng.randn(B, in_ch, t_mel // 2).astype(np.float32)
    t = rng.uniform(0, 999, (B,)).astype(np.float32)
    midi = rng.randint(0, MIDI_V, (B, 1, t_mel)).astype(np.int64)
    beats = rng.randint(0, BEATS_V, (B, 1, t_mel)).astype(np.int64)
    caption = rng.randn(B, n_cap, ori).astype(np.float32)
    return x, t, midi, beats, caption


def torch_context(midi, beats, caption):
    return {"c_concat": {"midi": torch.from_numpy(midi), "beats": torch.from_numpy(beats)},
            "c_crossattn": torch.from_numpy(caption)}


def jax_context(midi, beats, caption):
    import jax.numpy as jnp

    return {"c_concat": {"midi": jnp.asarray(midi), "beats": jnp.asarray(beats)},
            "c_crossattn": jnp.asarray(caption)}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32, to nearest with ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an fp32 register: the low 13 bits cut."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x as the flash kernels split an fp32 operand: (TF32 head, tail as the
    tensor core reads it)."""
    head = tf32_round(x)
    return head, tf32_read(x - head)


def split_tf32_trunc(x: torch.Tensor):
    """x as K5 splits an fp32 operand: (the TF32 head with the low 13 bits
    cut, the exact rest as the tensor core reads it)."""
    head = tf32_read(x)
    return head, tf32_read(x - head)


class Draws:
    """Stands in for a ``jax.random`` sampler: returns the given arrays (in
    their own dtypes) in call order."""

    def __init__(self, arrays):
        self.queue = [np.asarray(a) for a in arrays]

    def __call__(self, key, shape=(), *args, **kwargs):
        import jax.numpy as jnp

        a = self.queue.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a)


def assert_grads_match(model, jax_grads, tol=1e-4, floor=1e-3):
    """The module's ``.grad`` against a JAX gradient tree (mapped with
    ``state_dict_from_jax``), leaf by leaf: within ``tol`` of the leaf's own
    largest JAX gradient, or of ``floor`` x the largest over all leaves where
    the leaf's own is smaller (a leaf near 0 has no scale of its own). The
    self-attention projections, which the flash kernels' backward feeds, must
    get a nonzero gradient."""
    ref = state_dict_from_jax(jax_grads, "dit")
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(ref) == set(got)
    scale = max(v.abs().max().item() for v in ref.values())
    assert scale > 0
    for k, g in got.items():
        g = torch.zeros_like(ref[k]) if g is None else g
        err = (g - ref[k]).abs().max().item()
        own = ref[k].abs().max().item()
        assert err <= tol * max(own, floor * scale), (k, err, own, scale)
        if k.endswith(("attention.wq.weight", "attention.wk.weight", "attention.wv.weight")):
            assert g.abs().max().item() > 0, k


# -- T5 caption tower fixtures -------------------------------------------------
T5_TINY = dict(d_model=16, d_ff=32, d_kv=8, num_heads=2, num_layers=2, vocab_size=256)


def build_charsmap(mapping: dict) -> bytes:
    """A sentencepiece precompiled charsmap for ``{source: replacement}``: a
    u32 trie size, a darts-clone double array (one 256-unit block per trie
    node; a node's leaf value sits at label 0 of its block), then the
    NUL-terminated replacements."""
    import struct

    trie = {}
    for src in mapping:
        node = trie
        for b in src.encode():
            node = node.setdefault(b, {})
        node[None] = src
    normalized, offsets = b"", {}
    for src, dst in mapping.items():
        offsets[src] = len(normalized)
        normalized += dst.encode() + b"\0"
    units = [0] * 256

    def place(node, pos):
        base = len(units)
        units.extend([0] * 256)
        offset = pos ^ base
        assert offset < (1 << 21)
        units[pos] = (units[pos] & 0xFF) | (int(None in node) << 8) | (offset << 10)
        if None in node:
            units[base] = offsets[node[None]] | (1 << 31)
        for label, child in node.items():
            if label is not None:
                units[base ^ label] = label
                place(child, base ^ label)

    place(trie, 0)
    return (struct.pack("<I", 4 * len(units)) + struct.pack(f"<{len(units)}I", *units)
            + normalized)


# full-width letters, a ligature and NBSP, as nmt_nfkc maps them
CHARSMAP = {"Ａ": "A", "ｂ": "b", "Ｓ": "S", "ｔ": "t", "ﬁ": "fi", "ﬂ": "fl", " ": " ",
            "①": "1", "é": "é"}


def caption_corpus(n: int = 60, seed: int = 0) -> list:
    """Captions as the CLI builds them (``CaptionGenerator2``, reference templates)."""
    from versband_tpu.text.caption_generator import CaptionGenerator2

    gen = CaptionGenerator2(rng=np.random.default_rng(seed), templates="reference")
    keys = ["C major", "a minor", "F# major", "E- minor", "B- major"]
    out = []
    for i in range(n):
        prompt = gen.transcribe(key=keys[i % 5], key_conf=0.9, avg_pitch=50.0 + 3 * (i % 11),
                                tempo=60.0 + 13 * (i % 9), tempo_conf=0.8,
                                emotion=None, duration=4.0 + i % 17)
        out.append(f"Style: pop ballad with piano {i % 7} Musical: {prompt}")
    return out


def train_unigram_tokenizer(captions, vocab_size: int = 200, charsmap: bytes = None):
    """A T5-style ``tokenizers.Tokenizer`` trained on ``captions``: Precompiled
    (when given) and ' {2,}' -> ' ' normalizers, WhitespaceSplit + Metaspace,
    a Unigram model with <pad> 0, </s> 1, <unk> 2, and '$A </s>'."""
    from tokenizers import Regex, Tokenizer, models, normalizers, pre_tokenizers, processors
    from tokenizers import trainers

    tok = Tokenizer(models.Unigram())
    norms = [normalizers.Replace(Regex(" {2,}"), " ")]
    if charsmap is not None:
        norms.insert(0, normalizers.Precompiled(charsmap))
    tok.normalizer = normalizers.Sequence(norms)
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.WhitespaceSplit(),
        pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")])
    tok.train_from_iterator(captions, trainers.UnigramTrainer(
        vocab_size=vocab_size, special_tokens=["<pad>", "</s>", "<unk>"], unk_token="<unk>"))
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 1)])
    return tok


def write_t5_dir(path, config: dict, seed: int = 0, tokenizer=None,
                 safe_serialization: bool = True):
    """A Hugging Face T5 encoder checkpoint directory (``config.json``, random
    weights from ``seed``) and, given a ``tokenizers.Tokenizer``, its
    ``tokenizer.json`` (saved through ``T5TokenizerFast`` so that
    ``AutoTokenizer`` reads it back)."""
    from transformers import T5Config, T5EncoderModel, T5TokenizerFast

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = T5EncoderModel(T5Config(**config)).eval()
    model.save_pretrained(str(path), safe_serialization=safe_serialization)
    if tokenizer is not None:
        T5TokenizerFast(tokenizer_object=tokenizer, eos_token="</s>", pad_token="<pad>",
                        unk_token="<unk>", extra_ids=0).save_pretrained(str(path))
    return model


def write_v2a_manifest(root, n_rows: int, lengths=(40, 52, 60), seed: int = 0,
                       vocal_extra=(0, 3, 9), captions=("piano<psep>a soft piano accompaniment",
                                                         "rock<psep>loud guitars<psep>drums")):
    """A vocal-to-accompaniment manifest under ``root`` in the reference's
    columns (written with pandas): one mel and vocal-mel ``.npy`` pair per
    entry of ``lengths`` (the vocal mel longer by ``vocal_extra``: more than
    5 frames trips the dataset's length guard), shared round-robin by
    ``n_rows`` rows whose durations tie, and ``midi.npy``/``beats.npy``
    dicts. Returns the manifest directory and the ``midi.npy`` path."""
    import os

    import pandas as pd

    root = str(root)
    os.makedirs(f"{root}/manifests", exist_ok=True)
    rng = np.random.default_rng(seed)
    pairs = []
    for i, (T, extra) in enumerate(zip(lengths, vocal_extra)):
        mp, vp = f"{root}/u{i}_mel.npy", f"{root}/u{i}_vocal_mel.npy"
        np.save(mp, (rng.standard_normal((80, T)) * 0.5 - 1.0).astype(np.float32))
        np.save(vp, (rng.standard_normal((80, T + extra)) * 0.5).astype(np.float32))
        pairs.append((mp, vp, T))
    rows, midi, beats = [], {}, {}
    for j in range(n_rows):
        mp, vp, T = pairs[j % len(pairs)]
        name = f"song{j}"
        midi[name] = rng.integers(0, 128, T).astype(np.int64)
        beats[name] = rng.integers(0, 2, T).astype(np.int64)
        rows.append(dict(name=name, dataset="synthetic", mel_path=mp, vocal_mel_path=vp,
                         duration=T / 75.0, caption=captions[j % len(captions)],
                         key=("C major", "A minor")[j % 2], key_confidence=0.9,
                         avg_pitch=60.0 + j % 7, tempo=90.0 + 5 * (j % 5),
                         tempo_confidence=0.8, emotion="['calm']", wav_len=T / 75.0,
                         audio_path=""))
    pd.DataFrame(rows).to_csv(f"{root}/manifests/music.tsv", sep="\t", index=False)
    np.save(f"{root}/midi.npy", midi, allow_pickle=True)
    np.save(f"{root}/beats.npy", beats, allow_pickle=True)
    return f"{root}/manifests", f"{root}/midi.npy"


# stage 1: the JAX suite's tiny VAE (tests/test_vae_gan_training.py TINY_DD)
# and a PatchGAN of hidden size 8 and 2 layers
VAE_GAN_DD = dict(double_z=True, in_channels=80, out_ch=80, z_channels=4, kernel_size=5, ch=16,
                  ch_mult=[1, 2], num_res_blocks=1, attn_layers=[], down_layers=[0],
                  dropout=0.0)
VAE_GAN_DISC = dict(disc_hidden_size=8, disc_num_layers=2)


def record_normals(monkeypatch) -> list:
    """Every ``jax.random.normal`` draw, recorded in program order as the
    (jitted) JAX code makes it."""
    import jax

    draws = []
    real = jax.random.normal

    def normal(*args, **kwargs):
        v = real(*args, **kwargs)
        jax.debug.callback(lambda a: draws.append(np.asarray(a).copy()), v, ordered=True)
        return v

    monkeypatch.setattr(jax.random, "normal", normal)
    return draws


def one_draw(draws: list) -> torch.Tensor:
    """The draw of a step whose forwards all drew the same noise (emptying
    ``draws``)."""
    import jax

    jax.effects_barrier()
    assert draws and all(np.array_equal(d, draws[0]) for d in draws), len(draws)
    out = torch.from_numpy(draws[0])
    draws.clear()
    return out


def jax_loss_vars(loss, mel, seed: int = 3):
    """A JAX ``VAEGANLoss``'s variables, every leaf perturbed (variances kept
    positive, logvar kept), so the BatchNorm statistics matter."""
    import jax
    import jax.numpy as jnp

    v = loss.init(jax.random.PRNGKey(seed), jnp.asarray(mel), method="disc_forward")
    leaves, tree = jax.tree_util.tree_flatten_with_path(v)
    rng = np.random.RandomState(seed)
    out = []
    for path, leaf in leaves:
        name = jax.tree_util.keystr(path)
        a = np.asarray(leaf)
        if "logvar" in name:
            out.append(a)
        elif "var" in name:
            out.append((a * np.exp(0.3 * rng.randn(*a.shape))).astype(np.float32))
        else:
            out.append((a + 0.1 * rng.randn(*a.shape)).astype(np.float32))
    return jax.tree_util.tree_unflatten(tree, [jnp.asarray(a) for a in out])


def port_loss(jvars, **kw):
    """The port's ``VAEGANLoss`` holding the JAX variables ``jvars``."""
    import jax

    from versband_tpu_torch.train.gan_losses import VAEGANLoss

    loss = VAEGANLoss(**{**VAE_GAN_DISC, **kw})
    loss.load_state_dict(state_dict_from_jax(jax.device_get(jvars), "vaegan_loss"))
    return loss


def port_vae(seed: int = 0):
    """The port's tiny stage-1 VAE, GroupNorm affine parameters varied."""
    from versband_tpu_torch.models.autoencoder import AutoencoderKL

    torch.manual_seed(seed)
    vae = AutoencoderKL(embed_dim=4, ddconfig=VAE_GAN_DD)
    with torch.no_grad():  # they start at 1/0
        for name, p in vae.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn(p.shape))
    return vae


def write_stage1_manifest(root, n_rows: int, lengths=(25, 40, 57, 71), seed: int = 0,
                          corrupt: bool = True, nested: bool = True):
    """A manifest of ``n_rows`` rows over one mel per entry of ``lengths``
    and, with ``corrupt``, an unreadable file, written with pandas, in a
    subdirectory of the returned manifest directory where ``nested``
    (``fixed_len`` reads recursively, ``anylen`` does not)."""
    import pandas as pd

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, T in enumerate(lengths):
        p = root / f"mel{i}.npy"
        np.save(p, rng.standard_normal((80, T)).astype(np.float32))
        paths.append(str(p))
    if corrupt:
        bad = root / "corrupt.npy"
        bad.write_bytes(b"\x93NUMPY garbage")
        paths.append(str(bad))
    rows = [dict(name=f"song{j % 7}", mel_path=paths[j % len(paths)],
                 duration=float(1 + (j * 37) % 11) / 2,
                 caption=("" if j % 5 == 0 else f"caption {j % 3}"),
                 ori_cap=f"ori {j % 4}") for j in range(n_rows)]
    where = root / "manifests" / ("sub" if nested else "")
    where.mkdir(parents=True, exist_ok=True)
    pd.DataFrame(rows).to_csv(where / "a.tsv", sep="\t", index=False)
    return str(root / "manifests")


# -- BERT / CLAP fixtures ------------------------------------------------------
# tests/test_clap_conversion.py's tiny CLAP geometry (4 conv blocks, so a
# clip of 512 samples at 8 kHz keeps a frame after its three pools)
BERT_TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=48, vocab_size=211)
CLAP_TINY = dict(d_proj=12, cnn_kwargs=dict(
    sample_rate=8000, window_size=256, hop_size=64, mel_bins=64, fmin=50.0, fmax=3800.0,
    classes_num=5, out_emb=16, channels=(4, 8, 8, 16)))
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
WORDPIECE_CORPUS = [
    "A calm piano ballad in C major, slow tempo.", "Heavy drums; loud guitars!",
    "Crème brûlée à la café: naïve façade", "中文 歌曲 with 鋼琴 and strings",
    "punctuation (brackets) [x] {y} $100 #tag @me 50% a+b=c ~tilde", "ÀÉÎÕÜ ΟΔΟΣ straße",
    "soft jazz with saxophone and double bass", "electronic dance music at 128 bpm"]


def train_wordpiece_tokenizer(corpus=WORDPIECE_CORPUS, vocab_size: int = 211,
                              lowercase: bool = True, strip_accents=None,
                              max_input_chars_per_word: int = 100):
    """A bert-base-uncased style ``tokenizers.Tokenizer`` trained on ``corpus``:
    BertNormalizer, BertPreTokenizer, WordPiece with [UNK] and ``##``,
    ``[CLS] $A [SEP]``."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors, trainers

    tok = Tokenizer(models.WordPiece(unk_token="[UNK]",
                                     max_input_chars_per_word=max_input_chars_per_word))
    tok.normalizer = normalizers.BertNormalizer(lowercase=lowercase, strip_accents=strip_accents)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.train_from_iterator(list(corpus) * 3, trainers.WordPieceTrainer(
        vocab_size=vocab_size, special_tokens=SPECIALS))
    cls, sep = tok.token_to_id("[CLS]"), tok.token_to_id("[SEP]")
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", special_tokens=[("[CLS]", cls), ("[SEP]", sep)])
    return tok


def write_bert_dir(path, config: dict = BERT_TINY, seed: int = 0, tokenizer="train",
                   safe_serialization: bool = True):
    """A Hugging Face BERT checkpoint directory (``config.json``, random
    ``transformers.BertModel`` weights from ``seed``) and, unless
    ``tokenizer`` is None, a WordPiece tokenizer saved through
    ``BertTokenizerFast`` (``tokenizer.json``, ``vocab.txt``)."""
    from transformers import BertConfig, BertModel, BertTokenizerFast

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = BertModel(BertConfig(**config)).eval()
    model.save_pretrained(str(path), safe_serialization=safe_serialization)
    if tokenizer is not None:
        tok = train_wordpiece_tokenizer(vocab_size=config["vocab_size"]) \
            if tokenizer == "train" else tokenizer
        BertTokenizerFast(tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]",
                          cls_token="[CLS]", sep_token="[SEP]",
                          mask_token="[MASK]").save_pretrained(str(path))
    return path
