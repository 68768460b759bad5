"""The T5 encoder in plain PyTorch, and reading it from a local checkpoint directory.

The counterpart of ``transformers``' ``T5EncoderModel`` / ``FlaxT5EncoderModel``,
which the JAX caption tower calls (``versband_tpu/text/embedders.py:76,88-99,
116-120``), in eval mode (no dropout):

* a shared token embedding;
* per block, pre-norm self-attention and a pre-norm feed-forward, each added
  to the residual stream; the norm is ``T5LayerNorm`` (RMS, no mean, no bias,
  computed in fp32);
* attention with **no** 1/sqrt(d) scaling and a relative-position bias:
  bidirectional buckets (``relative_attention_num_buckets``, ``..._max_distance``)
  computed as ``transformers`` computes them, in fp32 on the CPU, kept on the
  device once per length, looked up by block 0's table in every forward and
  added in every block;
* ``DenseReluDense`` (``feed_forward_proj: relu``, T5Config's default) or the
  gated tanh-GELU one (``gated-gelu``, flan-t5);
* a final norm.

State-dict keys are Hugging Face's (``shared.weight``,
``encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}.weight``, ...), so a
checkpoint directory loads as it is. The products and softmax are plain
``torch.matmul``/``softmax``: in the JAX package they run in XLA, not in a
Pallas kernel.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from versband_tpu_torch.utils.safetensors_io import load_safetensors

# transformers' T5Config defaults
T5_DEFAULTS = dict(vocab_size=32128, d_model=512, d_kv=64, d_ff=2048, num_layers=6,
                   num_heads=8, relative_attention_num_buckets=32,
                   relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
                   initializer_factor=1.0, feed_forward_proj="relu")


def t5_config(**overrides: Any) -> Dict[str, Any]:
    """T5Config's defaults with ``overrides``; keys the encoder does not read
    (a ``config.json``'s decoder and tokenizer entries) are dropped."""
    return {k: overrides.get(k, v) for k, v in T5_DEFAULTS.items()}


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 buckets of ``key - query`` positions, in fp32 as
    ``transformers`` computes them."""
    num_buckets //= 2
    buckets = (relative_position > 0).to(torch.long) * num_buckets
    relative_position = torch.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = relative_position < max_exact
    large = max_exact + (torch.log(relative_position.float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(torch.long)
    large = torch.min(large, torch.full_like(large, num_buckets - 1))
    return buckets + torch.where(is_small, relative_position, large)


class T5LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.variance_epsilon = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.to(torch.float32).pow(2).mean(-1, keepdim=True)
        x = x * torch.rsqrt(var + self.variance_epsilon)
        if self.weight.dtype in (torch.float16, torch.bfloat16):
            x = x.to(self.weight.dtype)
        return self.weight * x


class T5Attention(nn.Module):
    def __init__(self, cfg: Dict[str, Any], has_relative_attention_bias: bool):
        super().__init__()
        self.n_heads, self.d_kv = cfg["num_heads"], cfg["d_kv"]
        inner = self.n_heads * self.d_kv
        self.q = nn.Linear(cfg["d_model"], inner, bias=False)
        self.k = nn.Linear(cfg["d_model"], inner, bias=False)
        self.v = nn.Linear(cfg["d_model"], inner, bias=False)
        self.o = nn.Linear(inner, cfg["d_model"], bias=False)
        self.num_buckets = cfg["relative_attention_num_buckets"]
        self.max_distance = cfg["relative_attention_max_distance"]
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(self.num_buckets, self.n_heads)
        self._buckets: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def bucket_indices(self, length: int, device: torch.device) -> torch.Tensor:
        """``[L, L]`` bucket of each (query, key) pair on ``device``: computed on
        the CPU, so that every device looks up the same ones, copied once per
        (length, device) and kept, so a forward copies nothing from the host
        (and a CUDA graph can capture it)."""
        key = (length, torch.device(device))
        buckets = self._buckets.get(key)
        if buckets is None:
            pos = torch.arange(length, dtype=torch.long)
            buckets = relative_position_bucket(pos[None, :] - pos[:, None], self.num_buckets,
                                               self.max_distance).to(device)
            self._buckets[key] = buckets
        return buckets

    def compute_bias(self, length: int) -> torch.Tensor:
        """``[1, H, L, L]`` bias, looked up in the table at every call (a table
        changed in place shows in the next bias)."""
        table = self.relative_attention_bias.weight
        return table[self.bucket_indices(length, table.device)].permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape

        def heads(t):
            return t.view(B, L, self.n_heads, self.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        scores = torch.matmul(q, k.transpose(3, 2)) + bias  # no 1/sqrt(d) in T5
        attn = F.softmax(scores.float(), dim=-1).type_as(scores)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, L, self.n_heads * self.d_kv)
        return self.o(out)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: Dict[str, Any], has_relative_attention_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_attention_bias)
        self.layer_norm = T5LayerNorm(cfg["d_model"], cfg["layer_norm_epsilon"])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return x + self.SelfAttention(self.layer_norm(x), bias)


class T5DenseActDense(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.wi = nn.Linear(cfg["d_model"], cfg["d_ff"], bias=False)
        self.wo = nn.Linear(cfg["d_ff"], cfg["d_model"], bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.relu(self.wi(x)))


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.wi_0 = nn.Linear(cfg["d_model"], cfg["d_ff"], bias=False)
        self.wi_1 = nn.Linear(cfg["d_model"], cfg["d_ff"], bias=False)
        self.wo = nn.Linear(cfg["d_ff"], cfg["d_model"], bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # transformers' "gelu_new": the tanh approximation
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        proj = cfg["feed_forward_proj"]
        if proj == "relu":
            self.DenseReluDense = T5DenseActDense(cfg)
        elif proj == "gated-gelu":
            self.DenseReluDense = T5DenseGatedActDense(cfg)
        else:
            raise NotImplementedError(f"T5 feed_forward_proj {proj!r} (the port has relu and "
                                      f"gated-gelu)")
        self.layer_norm = T5LayerNorm(cfg["d_model"], cfg["layer_norm_epsilon"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: Dict[str, Any], has_relative_attention_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_attention_bias),
                                    T5LayerFF(cfg)])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.layer[1](self.layer[0](x, bias))


class T5Stack(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0) for i in range(cfg["num_layers"])])
        self.final_layer_norm = T5LayerNorm(cfg["d_model"], cfg["layer_norm_epsilon"])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        bias = self.block[0].layer[0].SelfAttention.compute_bias(h.shape[1]).to(h.dtype)
        for block in self.block:
            h = block(h, bias)
        return self.final_layer_norm(h)


class T5Encoder(nn.Module):
    """``input_ids [B, L]`` -> last hidden state ``[B, L, d_model]``, with no
    attention mask (the JAX tower passes an all-ones mask)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.config = t5_config(**(config or {}))
        self.shared = nn.Embedding(self.config["vocab_size"], self.config["d_model"])
        self.encoder = T5Stack(self.config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.encoder(self.shared(input_ids))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "T5Encoder":
        """transformers' T5 initialisation (factor ``initializer_factor``),
        drawn from ``generator`` on the CPU."""
        c, f = self.config, self.config["initializer_factor"]
        d, dkv, h, dff = c["d_model"], c["d_kv"], c["num_heads"], c["d_ff"]

        def normal_(w, std):
            w.copy_(torch.randn(w.shape, generator=generator) * std)

        normal_(self.shared.weight, f * 1.0)
        for name, p in self.named_parameters():
            if name.endswith("layer_norm.weight"):
                p.fill_(f * 1.0)
            elif name.endswith(("SelfAttention.q.weight",)):
                normal_(p, f * (d * dkv) ** -0.5)
            elif name.endswith(("SelfAttention.k.weight", "SelfAttention.v.weight")):
                normal_(p, f * d ** -0.5)
            elif name.endswith("SelfAttention.o.weight"):
                normal_(p, f * (h * dkv) ** -0.5)
            elif name.endswith("relative_attention_bias.weight"):
                normal_(p, f * d ** -0.5)
            elif name.endswith(("wi.weight", "wi_0.weight", "wi_1.weight")):
                normal_(p, f * d ** -0.5)
            elif name.endswith("wo.weight"):
                normal_(p, f * dff ** -0.5)
        return self


def read_checkpoint_dir(path: str) -> Dict[str, Any]:
    """``{"config": ..., "state_dict": ...}`` of a Hugging Face T5 directory:
    ``config.json`` and ``model.safetensors``, else ``pytorch_model.bin``.
    Only the encoder's weights are kept (a full seq2seq checkpoint also holds
    the decoder); a tied ``encoder.embed_tokens.weight`` stands in for a
    missing ``shared.weight``."""
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
    if "shared.weight" not in sd and "encoder.embed_tokens.weight" in sd:
        sd["shared.weight"] = sd["encoder.embed_tokens.weight"]
    sd = {k: v for k, v in sd.items()
          if k == "shared.weight" or (k.startswith("encoder.") and k != "encoder.embed_tokens.weight")}
    return {"config": config, "state_dict": sd}


def load_t5_encoder(path: str) -> T5Encoder:
    """The encoder of the checkpoint directory ``path``, on the CPU, in the
    checkpoint's dtype promoted to fp32 (strict: every weight must be there)."""
    ckpt = read_checkpoint_dir(path)
    model = T5Encoder(ckpt["config"])
    model.load_state_dict({k: v.float() for k, v in ckpt["state_dict"].items()})
    return model
