"""The frozen caption towers and the cond stages built on them (port of
``versband_tpu/text/embedders.py``).

* ``FlanT5Embedder``: captions -> ``[B, max_length, d_model]``;
* ``TextVocalEmbedder``: the shipped cond stage; the cond dict comes back
  with ``caption`` replaced by the tower's hidden states and the acoustic
  dict passed through;
* ``TextVocalMusicalEmbedder``: ``<csep>``-split captions, both halves
  encoded and concatenated along the sequence.

On a card the T5 tower's encoder runs from a CUDA graph kept per input
signature (:func:`tower_graph_key`): the first call with a signature runs
eagerly, the second captures, later ones replay (``GraphSlots``, as the served
sampler does), so a call's ~700 launches become one. Tokenising stays on the
host; the ids go from a fresh pinned tensor straight into the graph's.

The tower loads a local Hugging Face checkpoint directory (``config.json``
and ``model.safetensors`` or ``pytorch_model.bin``, and ``tokenizer.json``).
With weights but no ``tokenizer.json`` it warns loudly and hashes words
(``HashTokenizer``), as JAX does. With no directory it is a random init of
``{**FALLBACK, **fallback_config}`` drawn from a ``torch.Generator`` seeded
with 0, with ``HashTokenizer(vocab_size)``. A directory whose weights
cannot be read raises: JAX would fall back to a random init there.

The BERT tower of CLAP (``_FrozenBertTower``) reads its directory the same
way (``tokenizer.json`` with a WordPiece model, or a bare ``vocab.txt``);
its fallback is ``{**FALLBACK, **fallback_config}`` with BERT's own init
from a generator seeded with 0. On it:

* ``ClapTextEmbedder``: every token's hidden state through CLAP's
  ``Projection`` (LayerNorm eps 1e-5, erf GELU) -> ``[B, L, d_proj]``;
* ``ClapFlanEmbedder``: CLAP's tokens of ``ori_caption``, then T5's of
  ``struct_caption``, along the sequence;
* ``ClassEmbedder`` (a class-id table) and ``SpatialRescaler`` (resizes
  with JAX's ``jax.image.resize`` semantics: antialiased bilinear, nearest
  at half-pixel centres; then an optional 1x1 remap).

JAX draws the random tables of the last three (the projection's init, the
class table, the remap) from ``jax.random``, which torch cannot replay; the
port draws the same distributions from a seeded ``torch.Generator``, and a
checkpoint or a copy of JAX's arrays sets them.
"""

from __future__ import annotations

import os
import threading
import warnings
from typing import Any, Dict, Hashable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

import torch.nn.functional as F

from versband_tpu_torch.device import DeviceLike, resolve_device
from versband_tpu_torch.models.cfm import GraphSlots, _Graph
from versband_tpu_torch.text.bert import BertModel, load_bert
from versband_tpu_torch.text.t5 import T5Encoder, load_t5_encoder
from versband_tpu_torch.text.tokenizer import (HashTokenizer, UnigramTokenizer,
                                               WordPieceTokenizer)
from versband_tpu_torch.utils.profiling import annotate, count

_TOWER_COUNTERS = {"eager": "text.tower.graph.eager", "capture": "text.tower.graph.captures",
                   "replay": "text.tower.graph.replays"}


def _local_exists(version: str) -> bool:
    return os.path.isdir(version) and os.path.exists(os.path.join(version, "config.json"))


def tower_graph_key(ids: torch.Tensor, device: torch.device, model: nn.Module) -> Hashable:
    """What fixes a tower call's captured work: the ids' shape (rows, length)
    and dtype, the device, the parameters' dtype, and the float32 matmul and
    cuDNN precision in force."""
    return (tuple(ids.shape), ids.dtype, device, next(model.parameters()).dtype,
            torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)


class _FrozenT5Tower(nn.Module):
    """Frozen FLAN-T5/T5 encoder on ``device``, with the offline fallbacks.

    On a CUDA device the encoder runs from CUDA graphs, one per
    :func:`tower_graph_key`, in a memory pool of their own. A weight changed in
    place shows in the next replay; if a parameter's storage is replaced, the
    graphs are dropped. Captures run in thread-local mode, so a trainer's
    prefetch thread captures while its main thread launches a step; a lock
    keeps callers on several threads from sharing the static buffers at once
    (they enqueue on one stream, as the trainer does)."""

    # default config of the random-init fallback (dev/test)
    FALLBACK = dict(d_model=1024, d_ff=2816, d_kv=64, num_heads=16, num_layers=2,
                    vocab_size=32128)

    def __init__(self, version: str = "google/flan-t5-large", max_length: int = 77,
                 fallback_config: Optional[dict] = None, device: DeviceLike = None):
        super().__init__()
        self.device = resolve_device(device)
        self.max_length = max_length
        self.tokenizer = None
        if _local_exists(version):
            self.model = load_t5_encoder(version)
            tok = os.path.join(version, "tokenizer.json")
            if os.path.exists(tok):
                self.tokenizer = UnigramTokenizer.from_file(tok)
            else:
                # real weights + hashed token ids = silently meaningless embeddings
                warnings.warn(
                    f"loaded T5 weights from {version} but found no tokenizer.json there; "
                    "falling back to HashTokenizer, so caption embeddings will NOT match the "
                    "reference. Place the fast tokenizer file (tokenizer.json) in that "
                    "directory (the port does not read spiece.model).", stacklevel=2)
        else:
            self.model = T5Encoder({**self.FALLBACK, **(fallback_config or {})})
            self.model.init_weights(torch.Generator().manual_seed(0))
        if self.tokenizer is None:
            self.tokenizer = HashTokenizer(self.model.config["vocab_size"])
        self.model.to(self.device).eval().requires_grad_(False)
        self.graphs = GraphSlots()
        self._graph_lock = threading.Lock()
        self._pool = self._stream = None
        self._storage: Tuple[int, ...] = ()

    def tokenize(self, text: Sequence[str]) -> np.ndarray:
        if isinstance(self.tokenizer, HashTokenizer):
            return self.tokenizer(list(text), self.max_length)["input_ids"]
        return self.tokenizer(list(text), max_length=self.max_length, truncation=True,
                              padding="max_length")["input_ids"]

    @torch.no_grad()
    def forward(self, text: Sequence[str]) -> torch.Tensor:
        """Hidden states ``[B, max_length, d_model]``, computed without
        autograd (``no_grad``, not ``inference_mode``: a trainer feeds them
        to layers it differentiates). On the card the ids go from a fresh
        pinned tensor (one reused across calls could be rewritten before its
        copy lands), so a caller on another thread does not wait for queued
        work, and the states come back as a copy of the graph's own."""
        with annotate("text.tower"):
            ids = torch.from_numpy(np.asarray(self.tokenize(text), np.int64))
            if self.device.type == "cuda":
                return self._on_card(ids.pin_memory())
            return self.model(ids.to(self.device))

    def _on_card(self, ids: torch.Tensor) -> torch.Tensor:
        key = tower_graph_key(ids, self.device, self.model)
        with self._graph_lock:
            storage = tuple(p.data_ptr() for p in self.model.parameters())
            if storage != self._storage:  # the graphs read the replaced storage
                self.graphs.clear()
                self._storage = storage
            action = self.graphs.decide(key)
            count(_TOWER_COUNTERS[action])
            if action == "eager":
                return self.model(ids.to(self.device, non_blocking=True))
            if action == "capture":
                self.graphs.put(key, self._capture(ids))
            return self.graphs.graphs[key].replay([ids])

    def _capture(self, ids: torch.Tensor) -> _Graph:
        """Capture the encoder over a static copy of ``ids`` on the tower's own
        stream and pool. It first runs once on that stream from this thread, so
        the thread's cuBLAS handle and the stream's workspace exist before the
        capture starts (the eager call may have run on another thread)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        static = ids.to(self.device, non_blocking=True)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            self.model(static)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            out = self.model(static)
        return _Graph(graph, [static], out, 0)


class FlanT5Embedder(nn.Module):
    """text list -> [B, max_length, d_model] (``modules.py:70-97``)."""

    def __init__(self, version: str = "google/flan-t5-large", device: DeviceLike = None,
                 max_length: int = 77, freeze: bool = True, **kw):
        super().__init__()
        self.tower = _FrozenT5Tower(version, max_length, kw.get("fallback_config"), device)

    def forward(self, text) -> torch.Tensor:
        return self.tower(text)

    def encode(self, text) -> torch.Tensor:
        return self(text)


class TextVocalEmbedder(nn.Module):
    """The shipped cond stage (``modules.py:194-233``): cond dict in, cond dict
    out with ``caption`` replaced by frozen-T5 hidden states."""

    def __init__(self, version: str = "google/t5-v1_1-large", device: DeviceLike = None,
                 max_length: int = 77, freeze: bool = True, **kw):
        super().__init__()
        self.tower = _FrozenT5Tower(version, max_length, kw.get("fallback_config"), device)
        self.max_length = max_length

    def forward(self, cond: Dict[str, Any]) -> Dict[str, Any]:
        z = self.tower(cond["caption"])
        return {"caption": z, "acoustic": cond["acoustic"], "name": cond.get("name")}

    def encode(self, cond):
        return self(cond)


class TextVocalMusicalEmbedder(TextVocalEmbedder):
    """``<csep>``-split dual encode, concatenated along the sequence
    (``modules.py:236-294``; the two halves kept apart, as in JAX)."""

    def forward(self, cond: Dict[str, Any]) -> Dict[str, Any]:
        captions, prompts = [], []
        for line in cond["caption"]:
            head, _, tail = line.partition("<csep>")
            captions.append(head)
            prompts.append(tail)
        z = torch.cat([self.tower(captions), self.tower(prompts)], dim=1)
        return {"caption": z, "acoustic": cond["acoustic"], "name": cond.get("name")}


class _FrozenBertTower(nn.Module):
    """Frozen BERT encoder for the CLAP caption tower, on ``device``, with the
    offline fallbacks (JAX ``text/embedders.py:184-250``): a directory's
    weights with its ``tokenizer.json`` (or ``vocab.txt``); weights without
    either warn and hash words; no directory gives the random ``FALLBACK``
    and ``HashTokenizer``. A directory whose weights cannot be read raises,
    where JAX falls back to a random init."""

    FALLBACK = dict(hidden_size=768, num_hidden_layers=2, num_attention_heads=12,
                    intermediate_size=1024, vocab_size=30522)

    def __init__(self, text_model: str = "bert-base-uncased", max_length: int = 77,
                 fallback_config: Optional[dict] = None, device: DeviceLike = None):
        super().__init__()
        self.device = resolve_device(device)
        self.max_length = max_length
        self.tokenizer = None
        if _local_exists(text_model):
            self.model = load_bert(text_model)
            self.tokenizer = _bert_tokenizer(text_model)
            if self.tokenizer is None:
                # real weights + hashed token ids = silently meaningless embeddings
                warnings.warn(
                    f"loaded BERT weights from {text_model} but found no tokenizer files "
                    "there; falling back to HashTokenizer, so caption embeddings will NOT "
                    "match the reference. Place tokenizer.json or vocab.txt in that "
                    "directory.", stacklevel=2)
        else:
            self.model = BertModel({**self.FALLBACK, **(fallback_config or {})})
            self.model.init_weights(torch.Generator().manual_seed(0))
        if self.tokenizer is None:
            self.tokenizer = HashTokenizer(self.model.config["vocab_size"])
        self.model.to(self.device).eval().requires_grad_(False)

    def tokenize(self, text: Sequence[str]) -> np.ndarray:
        if isinstance(self.tokenizer, HashTokenizer):
            return self.tokenizer(list(text), self.max_length)["input_ids"]
        return self.tokenizer(list(text), max_length=self.max_length, truncation=True,
                              padding="max_length")["input_ids"]

    @torch.no_grad()
    def forward(self, text: Sequence[str]) -> torch.Tensor:
        """``last_hidden_state`` ``[B, max_length, hidden_size]``."""
        ids = torch.from_numpy(np.asarray(self.tokenize(text), np.int64))
        return self.model(ids.to(self.device))


def _bert_tokenizer(path: str) -> Optional[WordPieceTokenizer]:
    """The directory's ``tokenizer.json``, else its ``vocab.txt`` with the
    flags of ``tokenizer_config.json`` (as ``AutoTokenizer`` reads them)."""
    tok = os.path.join(path, "tokenizer.json")
    if os.path.exists(tok):
        return WordPieceTokenizer.from_file(tok)
    vocab = os.path.join(path, "vocab.txt")
    if not os.path.exists(vocab):
        return None
    cfg_path = os.path.join(path, "tokenizer_config.json")
    cfg = {}
    if os.path.exists(cfg_path):
        import json

        with open(cfg_path) as f:
            cfg = json.load(f)
    return WordPieceTokenizer.from_vocab_file(vocab, cfg.get("do_lower_case", True),
                                              cfg.get("strip_accents"),
                                              cfg.get("tokenize_chinese_chars", True))


class Projection(nn.Module):
    """CLAP's projection, eval mode: ``layer_norm(l1(x) + l2(gelu(l1(x))))``
    (``CLAP/clap.py:8-20``), erf GELU. JAX's caption-side projection uses
    LayerNorm eps 1e-5 (``projection_apply``), its audio-side flax module
    flax's default 1e-6."""

    def __init__(self, d_in: int, d_out: int, eps: float = 1e-5):
        super().__init__()
        self.linear1 = nn.Linear(d_in, d_out, bias=False)
        self.linear2 = nn.Linear(d_out, d_out, bias=False)
        self.layer_norm = nn.LayerNorm(d_out, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e1 = self.linear1(x)
        return self.layer_norm(e1 + self.linear2(F.gelu(e1)))

    @torch.no_grad()
    def init_uniform(self, generator: torch.Generator) -> "Projection":
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights, as JAX's
        ``_projection_params`` draws them; a unit LayerNorm."""
        for lin in (self.linear1, self.linear2):
            s = lin.in_features ** -0.5
            lin.weight.copy_((torch.rand(lin.weight.shape, generator=generator) * 2 - 1) * s)
        self.layer_norm.weight.fill_(1.0)
        self.layer_norm.bias.zero_()
        return self


def load_caption_projection(path: str, proj: Projection) -> bool:
    """Set ``proj`` from a converted CLAP ``.npz`` (the JAX converter's
    ``caption_encoder/projection``); False when the file holds none."""
    from versband_tpu_torch.utils.checkpoint import load_npz_params
    from versband_tpu_torch.utils.convert import state_dict_from_jax

    tree = load_npz_params(path)
    tree = tree.get("params", tree)
    if "projection" not in tree.get("caption_encoder", {}):
        return False
    sd = state_dict_from_jax({"caption_encoder": tree["caption_encoder"]}, "clap")
    pre = "caption_encoder.projection."
    proj.load_state_dict({k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)})
    return True


class ClapTextEmbedder(nn.Module):
    """CLAP caption tower with the projection on every token
    (``modules.py:99-138``): texts -> ``[B, max_length, d_proj]``."""

    def __init__(self, weights_path: Optional[str] = None, freeze: bool = True,
                 device: DeviceLike = None, max_length: int = 77,
                 text_model: str = "bert-base-uncased", transformer_embed_dim: int = 768,
                 d_proj: int = 1024, **kw):
        super().__init__()
        self.tower = _FrozenBertTower(text_model, max_length, kw.get("fallback_config"), device)
        d_in = self.tower.model.config["hidden_size"]
        self.proj = Projection(d_in, d_proj).init_uniform(torch.Generator().manual_seed(0))
        if weights_path and os.path.exists(weights_path) and weights_path.endswith(".npz"):
            load_caption_projection(weights_path, self.proj)
        self.proj.to(self.tower.device).eval().requires_grad_(False)

    @torch.no_grad()
    def encode(self, text) -> torch.Tensor:
        return self.proj(self.tower(text))

    def forward(self, text) -> torch.Tensor:
        return self.encode(text)


class ClapFlanEmbedder(nn.Module):
    """CLAP(``ori_caption``) ++ T5(``struct_caption``) along the sequence
    (``modules.py:140-191``)."""

    def __init__(self, weights_path: Optional[str] = None,
                 t5version: str = "google/t5-v1_1-large", freeze: bool = True,
                 device: DeviceLike = None, max_length: int = 77, **kw):
        super().__init__()
        self.clap = ClapTextEmbedder(weights_path, max_length=max_length, device=device, **kw)
        self.t5 = _FrozenT5Tower(t5version, max_length, kw.get("fallback_config"), device)

    def encode(self, text: Dict[str, Any]) -> torch.Tensor:
        return torch.cat([self.clap.encode(text["ori_caption"]), self.t5(text["struct_caption"])],
                         dim=1)

    def forward(self, text) -> torch.Tensor:
        return self.encode(text)


class ClassEmbedder(nn.Module):
    """Class-id embedding (``modules.py:20-32``): ``batch[key]`` [B] ->
    ``[B, 1, embed_dim]``; the table N(0, 0.02^2), drawn from ``seed``."""

    def __init__(self, embed_dim: int, n_classes: int = 1000, key: str = "class", seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.key = key
        g = torch.Generator().manual_seed(seed)
        self.register_buffer("table", torch.randn((n_classes, embed_dim), generator=g) * 0.02)
        self.to(resolve_device(device))

    def forward(self, batch: Dict[str, Any], key: Optional[str] = None) -> torch.Tensor:
        c = torch.as_tensor(batch[key or self.key], device=self.table.device).long()
        return self.table[c[:, None]]


def resize_like_jax(x: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    """``jax.image.resize`` of ``[B, C, H, W]`` to ``size`` over H and W:
    ``bilinear``/``linear`` antialiased (a triangle kernel widened by the
    scale when downsampling, as ``F.interpolate(antialias=True)``), or
    ``nearest`` at half-pixel centres."""
    if method in ("bilinear", "linear"):
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)
    if method == "nearest":
        from versband_tpu_torch.models.ldm_variants import nearest_indices

        for dim, n in ((2, size[0]), (3, size[1])):
            idx = torch.from_numpy(nearest_indices(x.shape[dim], n)).to(x.device)
            x = x.index_select(dim, idx)
        return x
    raise NotImplementedError(f"SpatialRescaler method {method!r} (the port has bilinear, "
                              f"linear and nearest)")


class SpatialRescaler(nn.Module):
    """``n_stages`` resizes by ``multiplier`` and an optional bias-free 1x1
    remap to ``out_channels`` (``modules.py:34-59``), N(0, 1/in_channels)
    from ``seed``."""

    def __init__(self, n_stages: int = 1, method: str = "bilinear", multiplier: float = 0.5,
                 in_channels: int = 3, out_channels: Optional[int] = None, bias: bool = False,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.n_stages = n_stages
        self.method = method
        self.multiplier = multiplier
        self.remap = None
        if out_channels is not None:
            self.remap = nn.Conv2d(in_channels, out_channels, 1, bias=False)
            g = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                self.remap.weight.copy_(torch.randn(self.remap.weight.shape, generator=g)
                                        * in_channels ** -0.5)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.n_stages):
            H, W = x.shape[-2:]
            x = resize_like_jax(x, (int(H * self.multiplier), int(W * self.multiplier)),
                                self.method)
        return self.remap(x) if self.remap is not None else x
