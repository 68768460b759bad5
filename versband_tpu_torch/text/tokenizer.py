"""Caption tokenizers in pure Python: the hashing fallback and readers of
T5's and BERT's ``tokenizer.json``.

``HashTokenizer`` is a byte-exact copy of the JAX package's fallback
(``versband_tpu/text/embedders.py:39-59``): md5 of the lowercased words,
eos 1, pad 0.

``UnigramTokenizer`` reads what a T5 fast tokenizer file holds and
tokenizes as the ``tokenizers`` library does, with no package:

* added (special) tokens are split out of the raw text first;
* normalizers ``Sequence``, ``Replace`` (string or regex), ``NFC``/``NFKC``/
  ``NFD``/``NFKD``, ``Lowercase``, ``Strip`` and ``Precompiled``. The last is
  sentencepiece's darts-clone double-array charsmap: a grapheme shorter than
  6 bytes is looked up whole (the shortest matching prefix wins), otherwise
  each of its characters is;
* pre-tokenizers ``Sequence``, ``WhitespaceSplit`` and ``Metaspace``;
* a ``Unigram`` model: Viterbi over the pieces' scores, unknown characters
  scored ``min_score - 10`` and runs of them fused into one ``unk_id``;
* ``TemplateProcessing`` (``$A </s>``).

``WordPieceTokenizer`` reads BERT's file (bert-base-uncased's pipeline):

* the ``BertNormalizer``: clean_text (NUL, U+FFFD and control characters
  dropped, whitespace made a space), spaces around CJK ideographs, accents
  stripped (NFD, nonspacing marks dropped; by default when lowercasing),
  lowercase character by character;
* the ``BertPreTokenizer``: split on whitespace, punctuation isolated (ASCII
  punctuation and the Unicode P categories);
* a ``WordPiece`` model: greedy longest match from the word's start, later
  pieces with the ``##`` prefix; a word with no match, or longer than
  ``max_input_chars_per_word`` characters, becomes the unknown token;
* ``TemplateProcessing`` (``[CLS] $A [SEP]``) or ``BertProcessing``.

It also builds that pipeline from a bare ``vocab.txt``, as ``transformers``
converts a slow BERT tokenizer. The Bert components are read for a
WordPiece model only; a T5 file has none.

Both serve the call the JAX towers make (``:127-130``): truncation to
``max_length`` keeping room for the template's special tokens, padding to
``max_length`` with the pad id, int64 ids ``[B, max_length]``. A component of
another kind raises ``NotImplementedError`` naming it; none is dropped.
"""

from __future__ import annotations

import base64
import hashlib
import json
import re
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class HashTokenizer:
    """Deterministic fallback tokenizer (offline dev/test only): stable token
    ids via md5 of whitespace words, padded/truncated to max_length."""

    def __init__(self, vocab_size: int = 32128, pad_id: int = 0):
        self.vocab_size = vocab_size
        self.pad_id = pad_id

    def __call__(self, text, max_length: int = 77, **kw):
        if isinstance(text, str):
            text = [text]
        ids = np.full((len(text), max_length), self.pad_id, np.int32)
        for i, t in enumerate(text):
            words = t.lower().split()[: max_length - 1]
            for j, w in enumerate(words):
                h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
                ids[i, j] = 2 + h % (self.vocab_size - 2)
            ids[i, len(words)] = 1  # eos
        return {"input_ids": ids}


# Rust's char::is_whitespace (Unicode White_Space), which the tokenizers
# library splits and strips on; Python's str.isspace also takes U+001C-U+001F.
WHITESPACE = frozenset(map(chr, [*range(0x9, 0xE), 0x20, 0x85, 0xA0, 0x1680,
                                   *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F,
                                   0x3000]))
UNK_PENALTY = 10.0  # tokenizers' K_UNK_PENALTY


# -- grapheme clusters (UAX #29, extended) ------------------------------------
_CR, _LF, _CONTROL, _EXTEND, _ZWJ, _SPACING, _PREPEND, _RI, _L, _V, _T, _LV, _LVT, _PICT, _ANY = \
    range(15)
_PREPEND_CPS = frozenset([*range(0x600, 0x606), 0x6DD, 0x70F, 0x890, 0x891, 0x8E2, 0xD4E,
                          0x110BD, 0x110CD, *range(0x111C2, 0x111C4), 0x1193F, 0x11941,
                          0x11A3A, *range(0x11A84, 0x11A8A), 0x11D46])


def _gcb(c: str) -> int:
    """The Grapheme_Cluster_Break class of ``c``, from its general category
    and code point (the property itself is not in ``unicodedata``)."""
    cp = ord(c)
    if c == "\r":
        return _CR
    if c == "\n":
        return _LF
    if cp == 0x200D:
        return _ZWJ
    if cp in _PREPEND_CPS:
        return _PREPEND
    cat = unicodedata.category(c)
    if (cat in ("Mn", "Me") or cp == 0x200C or 0xFF9E <= cp <= 0xFF9F
            or 0x1F3FB <= cp <= 0x1F3FF or 0xE0020 <= cp <= 0xE007F):
        return _EXTEND
    if cat in ("Cc", "Zl", "Zp") or (cat == "Cf" and cp not in (0x200C, 0x200D)):
        return _CONTROL
    if cat == "Mc" or cp in (0x0E33, 0x0EB3):
        return _SPACING
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return _RI
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return _L
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return _V
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return _T
    if 0xAC00 <= cp <= 0xD7A3:
        return _LV if (cp - 0xAC00) % 28 == 0 else _LVT
    if (cat == "So" and (0x2190 <= cp <= 0x2BFF or 0x1F000 <= cp <= 0x1FAFF)) \
            or cp in (0xA9, 0xAE, 0x203C, 0x2049, 0x2122, 0x2139, 0x3030, 0x303D, 0x3297, 0x3299):
        return _PICT
    return _ANY


def graphemes(text: str) -> List[str]:
    """Extended grapheme clusters of ``text`` (rules GB3-GB13 of UAX #29)."""
    cls = [_gcb(c) for c in text]
    out: List[str] = []
    start, ri_run = 0, 0
    for i in range(1, len(text)):
        prev, cur = cls[i - 1], cls[i]
        ri_run = ri_run + 1 if prev == _RI else 0  # regional indicators ending at i - 1
        if prev == _CR and cur == _LF:
            join = True
        elif prev in (_CONTROL, _CR, _LF) or cur in (_CONTROL, _CR, _LF):
            join = False
        elif prev == _L and cur in (_L, _V, _LV, _LVT):
            join = True
        elif prev in (_LV, _V) and cur in (_V, _T):
            join = True
        elif prev in (_LVT, _T) and cur == _T:
            join = True
        elif cur in (_EXTEND, _ZWJ, _SPACING) or prev == _PREPEND:
            join = True
        elif prev == _ZWJ and cur == _PICT:  # ExtPict Extend* ZWJ x ExtPict
            j = i - 2
            while j >= 0 and cls[j] == _EXTEND:
                j -= 1
            join = j >= 0 and cls[j] == _PICT
        elif prev == _RI and cur == _RI:
            join = ri_run % 2 == 1
        else:
            join = False
        if not join:
            out.append(text[start:i])
            start = i
    if text:
        out.append(text[start:])
    return out


# -- the Precompiled normalizer ------------------------------------------------
class PrecompiledCharsmap:
    """sentencepiece's precompiled charsmap: a ``u32`` trie size, a
    darts-clone double array of that many bytes, then NUL-terminated
    replacement strings that the trie's values point into."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack("<I", blob[:4])
        self.units = struct.unpack(f"<{size // 4}I", blob[4:4 + size])
        self.normalized = blob[4 + size:]

    def prefix_values(self, key: bytes) -> List[int]:
        """darts-clone ``commonPrefixSearch``: the values of every prefix of
        ``key`` in the trie, shortest first."""
        units, out = self.units, []
        pos = 0
        unit = units[pos]
        pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= len(units):
                return out
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                return out
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                out.append(units[pos] & ((1 << 31) - 1))
        return out

    def transform(self, chunk: str) -> Optional[str]:
        found = self.prefix_values(chunk.encode("utf-8"))
        if not found:
            return None
        start = found[0]
        end = self.normalized.index(b"\0", start) if b"\0" in self.normalized[start:] \
            else len(self.normalized)
        return self.normalized[start:end].decode("utf-8")

    def __call__(self, text: str) -> str:
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for c in g:
                norm = self.transform(c)
                out.append(c if norm is None else norm)
        return "".join(out)


def _strip(text: str, left: bool, right: bool) -> str:
    i, j = 0, len(text)
    while left and i < j and text[i] in WHITESPACE:
        i += 1
    while right and j > i and text[j - 1] in WHITESPACE:
        j -= 1
    return text[i:j]


def _pattern(spec: dict) -> Tuple[str, bool]:
    if "String" in spec:
        return spec["String"], False
    if "Regex" in spec:
        return spec["Regex"], True
    raise NotImplementedError(f"pattern {spec}")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B920 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def bert_normalizer(clean_text: bool = True, handle_chinese_chars: bool = True,
                    strip_accents: Optional[bool] = None, lowercase: bool = True):
    """The ``tokenizers`` ``BertNormalizer`` as a ``str -> str`` function."""
    if strip_accents is None:
        strip_accents = lowercase

    def run(text: str) -> str:
        if clean_text:
            text = "".join(" " if (c in "\t\n\r" or c in WHITESPACE) else c for c in text
                           if not (c in "\0\ufffd" or (c not in "\t\n\r"
                                                       and unicodedata.category(c)[0] == "C")))
        if handle_chinese_chars:
            text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
        if strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if lowercase:
            text = "".join(c.lower() for c in text)  # per character, as Rust's to_lowercase
        return text
    return run


def _is_bert_punct(c: str) -> bool:
    return (c.isascii() and not c.isalnum() and 0x21 <= ord(c) <= 0x7E) \
        or unicodedata.category(c).startswith("P")


def bert_pre_tokenize(pieces):
    """The ``BertPreTokenizer``: whitespace removed, each punctuation
    character a piece of its own."""
    out = []
    for text, first in pieces:
        word, start = [], first
        for c in text:
            if c in WHITESPACE or _is_bert_punct(c):
                if word:
                    out.append(("".join(word), start))
                    word = []
                if c not in WHITESPACE:
                    out.append((c, start))
                start = False
            else:
                word.append(c)
        if word:
            out.append(("".join(word), start))
    return out


def build_normalizer(spec: Optional[dict], bert: bool = False):
    """A ``str -> str`` function for a ``tokenizer.json`` normalizer
    (``BertNormalizer`` only with ``bert``)."""
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "BertNormalizer" and bert:
        return bert_normalizer(spec.get("clean_text", True), spec.get("handle_chinese_chars", True),
                               spec.get("strip_accents"), spec.get("lowercase", True))
    if kind == "Sequence":
        steps = [build_normalizer(s, bert) for s in spec["normalizers"]]

        def run(s):
            for step in steps:
                s = step(s)
            return s
        return run
    if kind in ("NFC", "NFKC", "NFD", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Lowercase":
        return str.lower
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)
        return lambda s: _strip(s, left, right)
    if kind == "Replace":
        pat, is_regex = _pattern(spec["pattern"])
        content = spec["content"]
        if is_regex:
            rx = re.compile(pat)
            return lambda s: rx.sub(lambda m: content, s)
        return lambda s: s.replace(pat, content)
    if kind == "Precompiled":
        charsmap = spec["precompiled_charsmap"]
        if not charsmap:
            return lambda s: s
        blob = base64.b64decode(charsmap) if isinstance(charsmap, str) else bytes(charsmap)
        return PrecompiledCharsmap(blob)
    raise NotImplementedError(f"tokenizer.json normalizer {kind!r}")


def build_pre_tokenizer(spec: Optional[dict], bert: bool = False):
    """A ``(pieces) -> pieces`` function; each piece is ``(text, first)``,
    ``first`` saying the piece starts at offset 0 of the text
    (``BertPreTokenizer`` only with ``bert``)."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec["type"]
    if kind == "BertPreTokenizer" and bert:
        return bert_pre_tokenize
    if kind == "Sequence":
        steps = [build_pre_tokenizer(s, bert) for s in spec["pretokenizers"]]

        def run(pieces):
            for step in steps:
                pieces = step(pieces)
            return pieces
        return run
    if kind == "WhitespaceSplit":
        def split(pieces):
            out = []
            for text, first in pieces:
                word, start = [], first
                for c in text:
                    if c in WHITESPACE:
                        if word:
                            out.append(("".join(word), start))
                            word = []
                        start = False
                    else:
                        word.append(c)
                if word:
                    out.append(("".join(word), start))
            return out
        return split
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        if scheme not in ("always", "first", "never"):
            raise NotImplementedError(f"Metaspace prepend_scheme {scheme!r}")
        do_split = spec.get("split", True)

        def meta(pieces):
            out = []
            for text, first in pieces:
                text = text.replace(" ", rep)
                if not text.startswith(rep) and (scheme == "always" or (scheme == "first"
                                                                        and first)):
                    text = rep + text
                if not do_split:
                    out.append((text, first))
                    continue
                parts, cur = [], ""
                for c in text:  # the delimiter merged with the next piece
                    if c == rep and cur:
                        parts.append(cur)
                        cur = ""
                    cur += c
                if cur:
                    parts.append(cur)
                out += [(p, first and k == 0) for k, p in enumerate(parts)]
            return out
        return meta
    raise NotImplementedError(f"tokenizer.json pre_tokenizer {kind!r}")


class Unigram:
    """The ``tokenizers`` Unigram model (``encode_optimized``)."""

    def __init__(self, vocab: Sequence[Tuple[str, float]], unk_id: Optional[int]):
        self.pieces = {}
        for i, (piece, score) in enumerate(vocab):
            self.pieces.setdefault(piece, (i, float(score)))
        self.ids = {p: i for p, (i, _) in self.pieces.items()}
        self.max_len = max((len(p) for p in self.pieces), default=1)
        self.unk_id = unk_id
        self.min_score = min((float(s) for _, s in vocab), default=0.0)

    def tokenize(self, text: str) -> List[str]:
        n = len(text)
        if not n:
            return []
        unk_score = self.min_score - UNK_PENALTY
        best = [(0.0, None, -1)] * (n + 1)  # (score, start, id) of the best path ending here
        best[0] = (0.0, None, -1)
        for s in range(n):
            base = best[s][0]
            single = False
            for e in range(s + 1, min(n, s + self.max_len) + 1):
                hit = self.pieces.get(text[s:e])
                if hit is None:
                    continue
                cand = base + hit[1]
                if best[e][1] is None or cand > best[e][0]:
                    best[e] = (cand, s, hit[0])
                if e == s + 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"no piece covers {text[s]!r} and the model has no unk_id")
                cand = base + unk_score
                if best[s + 1][1] is None or cand > best[s + 1][0]:
                    best[s + 1] = (cand, s, self.unk_id)
        out, unk, e = [], [], n
        while e > 0:
            _, s, pid = best[e]
            if self.unk_id is not None and pid == self.unk_id:
                unk.append(text[s:e])
            else:
                if unk:
                    out.append("".join(reversed(unk)))
                    unk = []
                out.append(text[s:e])
            e = s
        if unk:
            out.append("".join(reversed(unk)))
        return out[::-1]

    def encode(self, text: str) -> List[int]:
        return [self.ids.get(t, self.unk_id) for t in self.tokenize(text)]


class WordPiece:
    """The ``tokenizers`` WordPiece model."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 continuing_subword_prefix: str = "##", max_input_chars_per_word: int = 100):
        self.ids = dict(vocab)
        self.unk_token = unk_token
        self.prefix = continuing_subword_prefix
        self.max_chars = max_input_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else self.prefix + word[start:end]
                if piece in self.ids:
                    break
                end -= 1
            else:
                return [self.unk_token]
            out.append(piece)
            start = end
        return out

    def encode(self, word: str) -> List[int]:
        return [self.ids[t] for t in self.tokenize(word)]


class _JsonTokenizer:
    """A ``tokenizer.json``: added tokens, normalizer, pre-tokenizer, the
    model of type ``MODEL``, post-processor; called as the JAX towers call
    ``transformers`` (see the module docstring)."""

    MODEL = ""
    PAD = ""
    BERT = False  # read the Bert normalizer, pre-tokenizer and post-processor

    def __init__(self, spec: Dict):
        model = spec["model"]
        if model.get("type") != self.MODEL:
            raise NotImplementedError(f"tokenizer.json model {model.get('type')!r}")
        self.model = self._build_model(model)
        self.normalize = build_normalizer(spec.get("normalizer"), self.BERT)
        self.pre_tokenize = build_pre_tokenizer(spec.get("pre_tokenizer"), self.BERT)
        self.added = {}
        for tok in spec.get("added_tokens") or []:
            if tok.get("normalized") or tok.get("lstrip") or tok.get("rstrip") \
                    or tok.get("single_word"):
                raise NotImplementedError(f"added token {tok['content']!r} with normalized, "
                                          f"lstrip, rstrip or single_word set")
            self.added[tok["content"]] = tok["id"]
        self._added_rx = (re.compile("|".join(re.escape(t) for t in
                                              sorted(self.added, key=len, reverse=True)))
                          if self.added else None)
        self.template, self.n_special = self._template(spec.get("post_processor"))
        pad = spec.get("padding") or {}
        self.pad_id = pad.get("pad_id", self.token_id(self.PAD, 0))

    def _build_model(self, spec: Dict):
        raise NotImplementedError

    def token_id(self, token: str, default: Optional[int] = None) -> Optional[int]:
        return self.added.get(token, self.model.ids.get(token, default))

    def _template(self, spec: Optional[dict]) -> Tuple[List, int]:
        if spec is None:
            return [("A", None)], 0
        if spec["type"] == "BertProcessing" and self.BERT:
            return [("S", [spec["cls"][1]]), ("A", None), ("S", [spec["sep"][1]])], 2
        if spec["type"] != "TemplateProcessing":
            raise NotImplementedError(f"tokenizer.json post_processor {spec['type']!r}")
        out, n = [], 0
        for part in spec["single"]:
            if "Sequence" in part:
                if part["Sequence"]["id"] != "A":
                    raise NotImplementedError("a single-sequence template reads only $A")
                out.append(("A", None))
            else:
                ids = spec["special_tokens"][part["SpecialToken"]["id"]]["ids"]
                out.append(("S", list(ids)))
                n += len(ids)
        return out, n

    @classmethod
    def from_file(cls, path: str):
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    def encode(self, text: str) -> List[int]:
        """Ids of ``text`` without the template's special tokens."""
        segments, pos = [], 0
        for m in (self._added_rx.finditer(text) if self._added_rx else ()):
            if m.start() > pos:
                segments.append((text[pos:m.start()], pos == 0))
            segments.append((m.group(0), None))
            pos = m.end()
        if pos < len(text):
            segments.append((text[pos:], pos == 0))
        ids = []
        for seg, first in segments:
            if first is None:
                ids.append(self.added[seg])
                continue
            pieces = self.pre_tokenize([(self.normalize(seg), first)])
            for piece, _ in pieces:
                ids += self.model.encode(piece)
        return ids

    def __call__(self, texts, max_length: int = 77, truncation: bool = True,
                 padding: str = "max_length", **kw) -> Dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        if padding != "max_length":
            raise NotImplementedError(f"padding={padding!r}")
        rows = []
        for t in texts:
            ids = self.encode(t)
            if truncation:
                ids = ids[:max(max_length - self.n_special, 0)]
            row = []
            for kind, special in self.template:
                row += ids if kind == "A" else special
            row = row[:max_length] if truncation else row
            rows.append(row + [self.pad_id] * (max_length - len(row)))
        return {"input_ids": np.asarray(rows, np.int64).reshape(len(rows), max_length)}


class UnigramTokenizer(_JsonTokenizer):
    """A T5 ``tokenizer.json`` (see the module docstring)."""

    MODEL = "Unigram"
    PAD = "<pad>"

    def _build_model(self, model: Dict) -> Unigram:
        if model.get("byte_fallback"):
            raise NotImplementedError("Unigram byte_fallback")
        return Unigram([tuple(v) for v in model["vocab"]], model.get("unk_id"))


class WordPieceTokenizer(_JsonTokenizer):
    """A BERT ``tokenizer.json`` (see the module docstring)."""

    MODEL = "WordPiece"
    PAD = "[PAD]"
    BERT = True

    def _build_model(self, model: Dict) -> WordPiece:
        return WordPiece(model["vocab"], model.get("unk_token", "[UNK]"),
                         model.get("continuing_subword_prefix", "##"),
                         model.get("max_input_chars_per_word", 100))

    @classmethod
    def from_vocab_file(cls, path: str, do_lower_case: bool = True,
                        strip_accents: Optional[bool] = None,
                        tokenize_chinese_chars: bool = True) -> "WordPieceTokenizer":
        """The pipeline ``transformers`` builds from a bare ``vocab.txt``
        (one token per line, ids by line), with the special tokens
        ``[PAD] [UNK] [CLS] [SEP] [MASK]`` that it holds."""
        with open(path, encoding="utf-8") as f:
            vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        specials = [t for t in ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]") if t in vocab]
        return cls({
            "model": {"type": "WordPiece", "vocab": vocab, "unk_token": "[UNK]"},
            "normalizer": {"type": "BertNormalizer", "clean_text": True,
                           "handle_chinese_chars": tokenize_chinese_chars,
                           "strip_accents": strip_accents, "lowercase": do_lower_case},
            "pre_tokenizer": {"type": "BertPreTokenizer"},
            "post_processor": {"type": "BertProcessing", "cls": ["[CLS]", vocab["[CLS]"]],
                               "sep": ["[SEP]", vocab["[SEP]"]]},
            "added_tokens": [{"id": vocab[t], "content": t} for t in specials]})
