"""Low-precision arithmetic that rounds where the JAX package rounds.

A flax module built with ``dtype=bfloat16`` keeps its parameters in float32
and casts kernels, embeddings and activations to bf16 at each op, and each
op's result is rounded to bf16 (``versband_tpu`` serves this way,
``bench.py:30-100``; a jitted program may keep a few fused intermediates in
float32, a freedom XLA's compiler takes). Torch rounds elsewhere in four kinds
of place, so in bf16 (or fp16) the port's DiT and VAE use the pieces below:

* a bias: flax adds it to the rounded product and rounds again, where a fused
  torch op rounds once (:class:`Linear`, :func:`linear`, :class:`Conv1d`);
* functions JAX composes from rounded steps, where torch computes in float32
  and rounds once: ``jax.nn.sigmoid`` is ``1 / (1 + exp(-x))``, the exact
  ``gelu`` ``0.5 * x * erfc(-x * sqrt(0.5))``, ``softmax`` ``exp(x - max) /
  sum`` (:func:`sigmoid`, :func:`silu`, :func:`gelu`, :func:`softmax`);
* a Python constant, which JAX rounds to the tensor's type (weak typing) and
  torch keeps at full precision (:func:`leaky_relu`'s slope);
* norms: flax keeps their scale and bias in float32 and normalises in
  float32, rounding once (:class:`LayerNorm`, :class:`GroupNorm`). A model is
  cast with :func:`cast_module`, which leaves those parameters, and the ones a
  module names in ``fp32_params``, in float32.

The vocoders keep torch's convs and round only their leaky slope: their
bf16 output stays within the JAX package's own bf16 gap without a second
bias pass over waveform-rate tensors (``tests/test_torch_port_bf16_serving.py``),
and on the card cuDNN adds a conv's bias to the rounded product anyway.
Where JAX asks for float32 products of bf16 operands
(``preferred_element_type``), the port calls :func:`linear_f32`. In float32
every piece is the plain torch op, so training is unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

LOW = (torch.bfloat16, torch.float16)


def _low(x: torch.Tensor) -> bool:
    return x.dtype in LOW


def _const(value: float, x: torch.Tensor) -> float:
    """``value`` rounded to ``x``'s type, as JAX rounds a weak-typed constant."""
    return float(torch.tensor(value, dtype=x.dtype)) if _low(x) else value


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    if not _low(x):
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x) if _low(x) else F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU."""
    if not _low(x):
        return F.gelu(x)
    return 0.5 * x * torch.erfc(-x * _const(math.sqrt(0.5), x))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    if not _low(x):
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    return F.leaky_relu(x, _const(negative_slope, x))


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    if bias is None or not _low(x):
        return F.linear(x, weight, bias)
    return F.linear(x, weight) + bias


def linear_f32(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` accumulated and returned in float32 (``jnp.einsum``
    with ``preferred_element_type=float32``): bf16 operands on the card go
    through a bf16 GEMM with a float32 output; elsewhere both are widened."""
    if x.is_cuda and _low(x) and weight.dtype == x.dtype:
        out = torch.mm(x.reshape(-1, x.shape[-1]), weight.t(), out_dtype=torch.float32)
        return out.view(*x.shape[:-1], weight.shape[0])
    return F.linear(x.float(), weight.float())


def layer_norm(x: torch.Tensor, shape, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    if not _low(x):
        return F.layer_norm(x, shape, weight, bias, eps)
    weight = None if weight is None else weight.float()
    bias = None if bias is None else bias.float()
    return F.layer_norm(x.float(), shape, weight, bias, eps).to(x.dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class Conv1d(nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None or not _low(x):
            return super().forward(x)
        return self._conv_forward(x, self.weight, None) + self.bias[:, None]


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not _low(x):
            return super().forward(x)
        weight = None if self.weight is None else self.weight.float()
        bias = None if self.bias is None else self.bias.float()
        return F.group_norm(x.float(), self.num_groups, weight, bias, self.eps).to(x.dtype)


class SiLU(nn.SiLU):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return silu(x)


class GELU(nn.GELU):
    """The exact GELU as :func:`gelu`; the tanh form is torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x) if self.approximate == "none" else super().forward(x)


class LeakyReLU(nn.LeakyReLU):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.negative_slope)


def cast_module(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``module.to(dtype)``, except that the parameters of this file's norms,
    and those a module names in its ``fp32_params``, stay float32 as flax
    keeps them. torch's own norms are cast: their forward takes parameters of
    the input's type."""
    for m in module.modules():
        norm = isinstance(m, (LayerNorm, GroupNorm))
        keep = getattr(m, "fp32_params", ())
        for name, p in m.named_parameters(recurse=False):
            if p.is_floating_point() and not norm and name not in keep:
                p.data = p.data.to(dtype)
        for name, b in m.named_buffers(recurse=False):
            if b.is_floating_point():
                setattr(m, name, b.to(dtype))
    return module
