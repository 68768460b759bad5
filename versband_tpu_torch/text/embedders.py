"""The frozen T5 caption tower and the cond stages built on it (port of
``versband_tpu/text/embedders.py:39-181``).

* ``FlanT5Embedder``: captions -> ``[B, max_length, d_model]``;
* ``TextVocalEmbedder``: the shipped cond stage; the cond dict comes back
  with ``caption`` replaced by the tower's hidden states and the acoustic
  dict passed through;
* ``TextVocalMusicalEmbedder``: ``<csep>``-split captions, both halves
  encoded and concatenated along the sequence.

The tower loads a local Hugging Face checkpoint directory (``config.json``
and ``model.safetensors`` or ``pytorch_model.bin``, and ``tokenizer.json``).
With weights but no ``tokenizer.json`` it warns loudly and hashes words
(``HashTokenizer``), as JAX does. With no directory it is a random init of
``{**FALLBACK, **fallback_config}`` drawn from a ``torch.Generator`` seeded
with 0, with ``HashTokenizer(vocab_size)``. A directory whose weights
cannot be read raises: JAX would fall back to a random init there.

The CLAP and BERT towers are not ported (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from versband_tpu_torch.device import DeviceLike, resolve_device
from versband_tpu_torch.text.t5 import T5Encoder, load_t5_encoder
from versband_tpu_torch.text.tokenizer import HashTokenizer, UnigramTokenizer


def _local_exists(version: str) -> bool:
    return os.path.isdir(version) and os.path.exists(os.path.join(version, "config.json"))


class _FrozenT5Tower(nn.Module):
    """Frozen FLAN-T5/T5 encoder on ``device``, with the offline fallbacks."""

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

    def tokenize(self, text: Sequence[str]) -> np.ndarray:
        if isinstance(self.tokenizer, HashTokenizer):
            return self.tokenizer(list(text), self.max_length)["input_ids"]
        return self.tokenizer(list(text), max_length=self.max_length, truncation=True,
                              padding="max_length")["input_ids"]

    @torch.no_grad()
    def forward(self, text: Sequence[str]) -> torch.Tensor:
        ids = torch.from_numpy(np.asarray(self.tokenize(text), np.int64)).to(self.device)
        return self.model(ids)


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
