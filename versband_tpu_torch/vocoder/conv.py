"""Conv helpers of the vocoders (port of the parts of ``versband_tpu/vocoder/conv.py``
that HiFi-GAN uses).

Weight norm is folded into plain weights for inference. Two conventions
exist: the JAX package's (``fold_weight_norm_jax``: flax kernel ``[k, C_in,
C_out]``, norm per output channel over all other axes, +1e-12 under the root)
and torch's ``weight_norm`` (``fold_torch_weight_norm``: norm over every dim
but 0, which is C_in for a ``ConvTranspose1d``), used by reference checkpoints.
The TPU-only polyphase transposed conv and space-to-depth blocking are not
ported: ``nn.ConvTranspose1d`` and ``nn.Conv1d`` compute the same function.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

LRELU_SLOPE = 0.1


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    """SAME padding for odd kernels."""
    return (kernel_size * dilation - dilation) // 2


def fold_weight_norm_jax(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """``kernel = v / ||v|| * g`` with the norm per last (output) axis."""
    norm = np.sqrt(np.sum(v * v, axis=tuple(range(v.ndim - 1)), keepdims=True) + 1e-12)
    return v / norm * g


def fold_torch_weight_norm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Collapse torch ``(weight_g, weight_v)`` pairs into plain ``weight``s."""
    out = {}
    for key, w in sd.items():
        if key.endswith("weight_v"):
            base = key[: -len("weight_v")]
            g = sd[base + "weight_g"]
            dims = tuple(range(1, w.ndim))
            norm = torch.sqrt((w.float() ** 2).sum(dim=dims, keepdim=True) + 1e-12)
            out[base + "weight"] = (w.float() / norm * g.float()).to(w.dtype)
        elif not key.endswith("weight_g"):
            out[key] = w
    return out
