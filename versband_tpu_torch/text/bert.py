"""The BERT encoder in plain PyTorch, and reading it from a local checkpoint directory.

The counterpart of ``transformers``' ``BertModel`` / ``FlaxBertModel``, which
the JAX CLAP caption tower calls (``versband_tpu/text/embedders.py:184-250``),
in eval mode (no dropout), returning ``last_hidden_state``:

* embeddings: word + absolute position (``arange``) + token type 0, then a
  LayerNorm with eps ``layer_norm_eps``;
* per layer, post-norm self-attention (scores scaled by 1/sqrt(head dim))
  and a post-norm feed-forward with erf GELU;
* no attention mask: the JAX tower passes an all-ones mask, pads included.

State-dict keys are Hugging Face's ``BertModel`` ones
(``embeddings.word_embeddings.weight``,
``encoder.layer.{i}.attention.self.query.weight``, ...). The pooler is left
out: ``last_hidden_state`` does not read it. A checkpoint's ``bert.``
prefix, ``LayerNorm.gamma``/``beta`` names, pooler and pre-training heads
are mapped or dropped on loading. The products and softmax are plain
``torch.matmul``/``softmax``: in the JAX package they run in XLA, not in a
Pallas kernel.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from versband_tpu_torch.utils.safetensors_io import load_safetensors, save_safetensors

# transformers' BertConfig defaults
BERT_DEFAULTS = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                     num_attention_heads=12, intermediate_size=3072, hidden_act="gelu",
                     max_position_embeddings=512, type_vocab_size=2, initializer_range=0.02,
                     layer_norm_eps=1e-12, pad_token_id=0, position_embedding_type="absolute")


def bert_config(**overrides: Any) -> Dict[str, Any]:
    """BertConfig's defaults with ``overrides``; keys the encoder does not
    read are dropped. An activation or position embedding the port lacks raises."""
    cfg = {k: overrides.get(k, v) for k, v in BERT_DEFAULTS.items()}
    if cfg["hidden_act"] != "gelu":
        raise NotImplementedError(f"BERT hidden_act {cfg['hidden_act']!r} (the port has gelu)")
    if cfg["position_embedding_type"] != "absolute":
        raise NotImplementedError(f"BERT position_embedding_type "
                                  f"{cfg['position_embedding_type']!r}")
    return cfg


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg["vocab_size"], cfg["hidden_size"])
        self.position_embeddings = nn.Embedding(cfg["max_position_embeddings"],
                                                cfg["hidden_size"])
        self.token_type_embeddings = nn.Embedding(cfg["type_vocab_size"], cfg["hidden_size"])
        self.LayerNorm = nn.LayerNorm(cfg["hidden_size"], eps=cfg["layer_norm_eps"])

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)
        h = (self.word_embeddings(input_ids) + self.token_type_embeddings.weight[0]
             + self.position_embeddings(pos)[None])
        return self.LayerNorm(h)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        d = cfg["hidden_size"]
        self.n_heads = cfg["num_attention_heads"]
        self.head_dim = d // self.n_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape

        def heads(t):
            return t.view(B, L, self.n_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        scores = torch.matmul(q, k.transpose(2, 3)) / math.sqrt(self.head_dim)
        out = torch.matmul(F.softmax(scores, dim=-1), v)
        return out.transpose(1, 2).reshape(B, L, D)


class BertDenseNorm(nn.Module):
    """``LayerNorm(dense(x) + residual)`` (BertSelfOutput / BertOutput)."""

    def __init__(self, d_in: int, d: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d)
        self.LayerNorm = nn.LayerNorm(d, eps=eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertDenseNorm(cfg["hidden_size"], cfg["hidden_size"], cfg["layer_norm_eps"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x), x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.dense = nn.Linear(cfg["hidden_size"], cfg["intermediate_size"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))  # erf GELU


class BertLayer(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertDenseNorm(cfg["intermediate_size"], cfg["hidden_size"],
                                    cfg["layer_norm_eps"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attention(x)
        return self.output(self.intermediate(h), h)


class BertEncoder(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg) for _ in range(cfg["num_hidden_layers"])])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for layer in self.layer:
            h = layer(h)
        return h


class BertModel(nn.Module):
    """``input_ids [B, L]`` -> last hidden state ``[B, L, hidden_size]``."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.config = bert_config(**(config or {}))
        self.embeddings = BertEmbeddings(self.config)
        self.encoder = BertEncoder(self.config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.encoder(self.embeddings(input_ids))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BertModel":
        """transformers' BERT initialisation (normal(0, ``initializer_range``)
        weights, zero biases, the pad row of the word embeddings zero, unit
        LayerNorms), drawn from ``generator`` on the CPU."""
        std = self.config["initializer_range"]
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * std)
                if isinstance(module, nn.Linear):
                    module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        pad = self.config["pad_token_id"]
        if pad is not None:
            self.embeddings.word_embeddings.weight[pad].zero_()
        return self


def _hf_names(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A checkpoint's keys as ``BertModel``'s: the ``bert.`` prefix of a
    pre-training checkpoint stripped, ``LayerNorm.gamma``/``beta`` renamed;
    the pooler, the heads and the position-id buffers dropped."""
    out = {}
    for k, v in sd.items():
        if k.startswith("bert."):
            k = k[len("bert."):]
        k = k.replace("LayerNorm.gamma", "LayerNorm.weight").replace("LayerNorm.beta",
                                                                     "LayerNorm.bias")
        if k.startswith(("embeddings.", "encoder.")) and not k.endswith(
                ("position_ids", "token_type_ids")):
            out[k] = v
    return out


def read_bert_dir(path: str) -> Dict[str, Any]:
    """``{"config": ..., "state_dict": ...}`` of a Hugging Face BERT
    directory: ``config.json`` and ``model.safetensors``, else
    ``pytorch_model.bin``; neither raises."""
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    st, binf = os.path.join(path, "model.safetensors"), os.path.join(path, "pytorch_model.bin")
    if os.path.exists(st):
        sd = load_safetensors(st)
    elif os.path.exists(binf):
        sd = torch.load(binf, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"{path} has a config.json but neither model.safetensors nor "
                                f"pytorch_model.bin")
    return {"config": config, "state_dict": _hf_names(sd)}


def load_bert(path: str) -> BertModel:
    """The encoder of the checkpoint directory ``path``, on the CPU, in fp32
    (strict: every weight must be there)."""
    ckpt = read_bert_dir(path)
    model = BertModel(ckpt["config"])
    model.load_state_dict({k: v.float() for k, v in ckpt["state_dict"].items()})
    return model


def save_bert_dir(model: BertModel, path: str) -> str:
    """``config.json`` and ``model.safetensors`` of ``model`` in ``path``, a
    directory ``load_bert`` and ``transformers`` read (its ``from_pt``
    loading asks for the ``format: pt`` metadata)."""
    os.makedirs(path, exist_ok=True)
    cfg = dict(model.config, architectures=["BertModel"], model_type="bert")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    save_safetensors({k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()},
                     os.path.join(path, "model.safetensors"), {"format": "pt"})
    return path
