"""Fused alias-free Snake activation: CUDA kernel K4 and its plain version.

BigVGAN's ``Activation1d`` (port of ``versband_tpu/ops/fused_act1d.py`` and
of the alias-free pieces of ``versband_tpu/vocoder/bigvgan.py``) is 2x
kaiser-sinc upsample, Snake or SnakeBeta ``y + sin^2(alpha y) / (beta +
1e-9)`` (``alpha``, ``beta`` exponentiated when ``logscale``), then 2x
kaiser-sinc low-pass and decimate, with the reference's replicate padding at
both resampling stages.

K4 (``csrc/fused_act1d.cu``) replaces ``_act_kernel``, the Pallas TPU kernel:
one pass, one read of x and one write of the output, the 2T signal kept in
shared memory; the source's header has the design. It is bound by HBM bytes.

Layout: ``[B, C, T]``, the port's ``nn.Conv1d`` layout, where the JAX entry
takes ``[B, T, C]``; each (b, c) row is contiguous in T, which suits the 1-D
stencil and spares a transpose around each of the 73 calls of a BigVGAN
forward. Tests transpose the JAX inputs and outputs.

On a CUDA tensor :func:`fused_alias_free_snake` launches K4 or raises; on a
CPU tensor it runs :func:`alias_free_snake_reference`, the unfused
``upsample1d -> snake -> downsample1d`` in fp32 (the reference's own
formulation); other devices raise. Unlike the JAX entry it never returns
``None``: the TPU's shape limits have no counterpart here. ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from versband_tpu_torch.ops import _build

LAUNCHES = 0
KERNEL_SIZE = 12  # taps of the 2x resampler, the only size K4 is built for
_FN = None
_FILTERS: Dict[Tuple[int, int, torch.device, torch.dtype], torch.Tensor] = {}


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass, sum-normalized (the reference's
    ``alias_free_torch/filter.py:28-57``)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    time = np.arange(-half_size, half_size) + 0.5 if even else np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    return (filt / filt.sum()).astype(np.float32)


def _default_kernel_size(ratio: int) -> int:
    return int(6 * ratio // 2) * 2


def _filter(ratio: int, k: int, x: torch.Tensor) -> torch.Tensor:
    """The ``[1, 1, k]`` resampling taps on x's device and type (cached)."""
    key = (ratio, k, x.device, x.dtype)
    if key not in _FILTERS:
        taps = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, k)
        _FILTERS[key] = torch.from_numpy(taps).to(x.device, x.dtype)[None, None]
    return _FILTERS[key]


def upsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: Optional[int] = None) -> torch.Tensor:
    """ratio-x kaiser-sinc upsample of ``[B, C, T]`` (``resample.py:10-33``):
    replicate padding, depthwise transposed conv, crop."""
    k = kernel_size or _default_kernel_size(ratio)
    pad = k // ratio - 1
    pad_left = pad * ratio + (k - ratio) // 2
    pad_right = pad * ratio + (k - ratio + 1) // 2
    C = x.shape[1]
    y = F.pad(x, (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(y, _filter(ratio, k, x).expand(C, -1, -1), stride=ratio,
                                   groups=C)
    return y[..., pad_left:y.shape[-1] - pad_right]


def downsample1d(x: torch.Tensor, ratio: int = 2,
                 kernel_size: Optional[int] = None) -> torch.Tensor:
    """ratio-x kaiser-sinc low-pass and decimate of ``[B, C, T]``
    (``resample.py:36-49``): replicate padding, strided depthwise conv."""
    k = kernel_size or _default_kernel_size(ratio)
    pad_left = k // 2 - int(k % 2 == 0)
    pad_right = k // 2
    C = x.shape[1]
    y = F.pad(x, (pad_left, pad_right), mode="replicate")
    return F.conv1d(y, _filter(ratio, k, x).expand(C, -1, -1), stride=ratio, groups=C)


def snake(x: torch.Tensor, alpha: torch.Tensor, beta: Optional[torch.Tensor] = None,
          logscale: bool = True) -> torch.Tensor:
    """Snake / SnakeBeta over ``[B, C, T]`` with per-channel ``alpha``,
    ``beta`` ``[C]``: ``x + sin^2(alpha x) / (beta + 1e-9)``, fp32 inner math,
    returned in x's type (``beta = None``: Snake, beta := alpha)."""
    a = alpha.float()
    b = a if beta is None else beta.float()
    if logscale:
        a, b = a.exp(), b.exp()
    xf = x.float()
    y = xf + (1.0 / (b + 1e-9))[None, :, None] * torch.sin(xf * a[None, :, None]) ** 2
    return y.to(x.dtype)


def alias_free_snake_reference(x: torch.Tensor, alpha: torch.Tensor,
                               beta: Optional[torch.Tensor] = None, logscale: bool = True,
                               kernel_size: int = KERNEL_SIZE) -> torch.Tensor:
    """Plain version of K4: ``upsample1d -> snake -> downsample1d`` in fp32,
    the output in x's type."""
    y = upsample1d(x.float(), 2, kernel_size)
    y = snake(y, alpha, beta, logscale)
    return downsample1d(y, 2, kernel_size).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _taps_c() -> ctypes.Array:
    return (ctypes.c_float * KERNEL_SIZE)(*kaiser_sinc_filter1d(0.25, 0.3, KERNEL_SIZE))


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("fused_act1d").vbt_fused_act1d
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _param(p: torch.Tensor, C: int, name: str, device: torch.device) -> torch.Tensor:
    if tuple(p.shape) != (C,):
        raise ValueError(f"{name} must be [C] = [{C}], got {tuple(p.shape)}")
    if p.device != device:
        raise ValueError(f"{name} must be on x's device {device}, got {p.device}")
    return p.detach().float().contiguous()


def _launch(x: torch.Tensor, alpha: torch.Tensor, beta: Optional[torch.Tensor],
            logscale: bool, kernel_size: int) -> torch.Tensor:
    global LAUNCHES
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_alias_free_snake takes float32 or bfloat16, got {x.dtype}")
    if kernel_size != KERNEL_SIZE:
        raise ValueError(f"K4 is built for kernel_size {KERNEL_SIZE}, got {kernel_size}")
    B, C, T = x.shape
    a = _param(alpha, C, "alpha", x.device)
    b = a if beta is None else _param(beta, C, "beta", x.device)
    out = torch.empty((B, C, T), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _kernel_fn()(x.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), B, C, T,
                           *x.stride(), int(logscale), _taps_c(),
                           int(x.dtype == torch.bfloat16),
                           torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_act1d launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out


def fused_alias_free_snake(x: torch.Tensor, alpha: torch.Tensor,
                           beta: Optional[torch.Tensor] = None, logscale: bool = True,
                           kernel_size: int = KERNEL_SIZE) -> torch.Tensor:
    """2x upsample -> Snake(Beta) -> 2x downsample over ``x`` ``[B, C, T]``.

    ``alpha``, ``beta``: ``[C]`` (before ``exp`` when ``logscale``; ``beta =
    None`` is Snake). Returns ``[B, C, T]`` in x's type. CUDA tensors (float32
    or bfloat16, fp32 math) go through K4, CPU tensors through the plain
    version; other devices raise.
    """
    if x.ndim != 3:
        raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
    if x.device.type == "cuda":
        return _launch(x, alpha, beta, logscale, kernel_size)
    if x.device.type == "cpu":
        return alias_free_snake_reference(x, alpha, beta, logscale, kernel_size)
    raise ValueError(f"fused_alias_free_snake runs on cuda or cpu, not {x.device}")
