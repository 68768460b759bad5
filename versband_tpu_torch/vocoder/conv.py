"""Conv helpers of the vocoders (port of the parts of ``versband_tpu/vocoder/conv.py``
that the generators and discriminators use).

Weight norm exists in two conventions. The JAX package trains the pair
(v, g) with the norm per output channel over all other axes and +1e-12 under
the root (``_wn_kernel``); for a transposed conv that is per ``C_out``.
torch's ``weight_norm`` (reference checkpoints) normalises over every dim
but 0, which is ``C_in`` for a ``ConvTranspose1d``. The port trains the JAX
convention: :func:`weight_norm` turns a plain conv into one whose ``weight``
is computed from ``weight_v`` and ``weight_g`` on every access, with ``g``
shaped ``[C_out, 1, ...]`` (``[1, C_out, 1]`` for a transposed conv), and
:func:`fold_weight_norm_` folds every such conv of a module back into a
plain weight for serving. Reference checkpoints are folded on load
(:func:`fold_torch_weight_norm`).

:func:`spectral_norm` is the JAX package's stateless spectral norm
(``discriminators.py:35-44``): 3 power iterations from the fixed vector
``ones / sqrt(n)`` on every call, no persistent ``u`` (torch's
``spectral_norm`` keeps a random one, a different function). The raw weight
is ``weight_orig``.

The TPU-only polyphase transposed conv and space-to-depth blocking are not
ported: ``nn.ConvTranspose1d`` and ``nn.Conv1d`` compute the same function.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

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


def _out_dim(conv: nn.Module) -> int:
    return 1 if isinstance(conv, nn.ConvTranspose1d) else 0


def jax_weight_norm(v: torch.Tensor, g: torch.Tensor, out_dim: int) -> torch.Tensor:
    """``v / sqrt(sum v^2 + 1e-12) * g``, the sum over every dim but ``out_dim``."""
    dims = [d for d in range(v.ndim) if d != out_dim]
    return v / torch.sqrt((v * v).sum(dims, keepdim=True) + 1e-12) * g


class _WeightNorm:
    """``weight`` from (``weight_v``, ``weight_g``), JAX's convention."""

    @property
    def weight(self) -> torch.Tensor:
        return jax_weight_norm(self.weight_v, self.weight_g, _out_dim(self))


class _SpectralNorm:
    """``weight`` = ``weight_orig`` over its largest singular value, estimated
    as JAX estimates it."""

    @property
    def weight(self) -> torch.Tensor:
        return spectral_normalize(self.weight_orig)


class WNConv1d(_WeightNorm, nn.Conv1d):
    pass


class WNConv2d(_WeightNorm, nn.Conv2d):
    pass


class WNConvTranspose1d(_WeightNorm, nn.ConvTranspose1d):
    pass


class SNConv1d(_SpectralNorm, nn.Conv1d):
    pass


class SNConv2d(_SpectralNorm, nn.Conv2d):
    pass


_WN = {nn.Conv1d: WNConv1d, nn.Conv2d: WNConv2d, nn.ConvTranspose1d: WNConvTranspose1d}
_SN = {nn.Conv1d: SNConv1d, nn.Conv2d: SNConv2d}


def weight_norm(conv: nn.Module) -> nn.Module:
    """Make ``conv`` (a plain Conv1d, Conv2d or ConvTranspose1d) hold its
    weight as (v, g) in JAX's convention, g initialised to the norm of the
    current weight so that the function is unchanged. Returns ``conv``."""
    w = conv._parameters.pop("weight").detach()
    out_dim = _out_dim(conv)
    conv.__class__ = _WN[type(conv)]
    dims = [d for d in range(w.ndim) if d != out_dim]
    conv.weight_v = nn.Parameter(w.clone())
    conv.weight_g = nn.Parameter(torch.sqrt((w * w).sum(dims, keepdim=True)))
    return conv


def spectral_norm(conv: nn.Module) -> nn.Module:
    """Make ``conv`` (a plain Conv1d or Conv2d) use JAX's stateless spectral
    norm; the raw weight becomes ``weight_orig``. Returns ``conv``."""
    w = conv._parameters.pop("weight")
    conv.__class__ = _SN[type(conv)]
    conv.weight_orig = w
    return conv


def apply_weight_norm(module: nn.Module, types=(nn.Conv1d, nn.ConvTranspose1d)) -> nn.Module:
    """:func:`weight_norm` on every plain conv of ``types`` inside ``module``."""
    for m in list(module.modules()):
        if type(m) in types:
            weight_norm(m)
    return module


@torch.no_grad()
def fold_weight_norm_(module: nn.Module) -> nn.Module:
    """Fold every (v, g) conv inside ``module`` into a plain conv holding the
    same weight (the serving form; the analogue of ``remove_weight_norm``)."""
    for m in module.modules():
        if isinstance(m, _WeightNorm):
            w = m.weight.detach().clone()
            del m.weight_v, m.weight_g
            m.__class__ = type(m).__mro__[2]  # the plain torch conv
            m.weight = nn.Parameter(w)
    return module


def spectral_normalize(w: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """``w / sigma`` with sigma from ``iters`` power iterations started at
    ``ones / sqrt(n)`` over the matrix [C_out, everything else] (JAX's
    ``_spectral_normalize``, whose [everything else, C_out] rows are in
    another order: the estimate does not depend on that order)."""
    mat = w.reshape(w.shape[0], -1)
    n = mat.shape[1]
    u = torch.full((n,), 1.0 / float(np.sqrt(n)), dtype=w.dtype, device=w.device)
    for _ in range(iters):
        v = mat @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = mat.t() @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
    sigma = u @ (mat.t() @ v)
    return w / (sigma + 1e-12)
