"""Fused gated-WaveNet residual layer: CUDA kernel K5 and its plain version.

One ParallelWaveGAN residual layer (port of ``versband_tpu/ops/fused_wavenet.py``;
reference ``parallel_wavegan/layers/residual_block.py:39-130``), per sample t:

    gate  = W_g0 x[t-d] + W_g1 x[t] + W_g2 x[t+d] + W_c c[t] + b_g   # [2G]
    z     = tanh(gate[:G]) * sigmoid(gate[G:])                        # [G]
    skip' = skip + W_s z + b_s                                        # [S], fp32
    x'    = (W_o z + b_o + x[t]) * sqrt(0.5)                          # [R]

with x zero outside the sequence. K5 (``csrc/fused_wavenet.cu``) replaces
``_layer_kernel``, the Pallas TPU kernel: one pass per layer, the gate and z
never leave the chip; the source's header has the design. It is bound by the
fp32 FMA rate. It takes any T and any dilation >= 1: the TPU kernel's block
grid, ``t_real`` tail and ``D_HALO = 512`` dilation limit have no counterpart.

Layout: ``[B, C, T]`` (the port's ``nn.Conv1d`` layout; the JAX entry takes
``[B, T, C]``). Weights come in ``nn.Conv1d`` layout: ``w_gate`` ``[2G, R,
3]``, ``w_aux`` ``[2G, A(, 1)]``, ``w_skip`` ``[S, G(, 1)]``, ``w_out`` ``[R,
G(, 1)]``; biases ``[2G]``, ``[S]``, ``[R]`` or None. Tests transpose the JAX
inputs and outputs.

On a CUDA tensor :func:`fused_wavenet_layer` launches K5 or raises; on a CPU
tensor it runs :func:`wavenet_layer_reference`, the dense layer with the skip
added in fp32; other devices raise. Neither updates ``skip`` in place: both
return a new ``skip'``. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from versband_tpu_torch.ops import _build

LAUNCHES = 0
HALF = 64  # K5 packs gate rows, skip and out channels into 64 + 64 rows
_FN = None


def _shapes(x, c, skip, w_gate, w_aux, w_skip, w_out, dilation) -> Tuple[int, ...]:
    """Check the layer's shapes; return (B, R, A, S, G, T)."""
    if x.ndim != 3 or c.ndim != 3 or skip.ndim != 3:
        raise ValueError("x, c and skip must be [B, C, T]")
    B, R, T = x.shape
    A, S = c.shape[1], skip.shape[1]
    if c.shape[0] != B or c.shape[2] != T or skip.shape[0] != B or skip.shape[2] != T:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, c {tuple(c.shape)}, "
                         f"skip {tuple(skip.shape)}")
    if w_gate.ndim != 3 or w_gate.shape[1:] != (R, 3) or w_gate.shape[0] % 2:
        raise ValueError(f"w_gate must be [2G, R={R}, 3], got {tuple(w_gate.shape)}")
    G = w_gate.shape[0] // 2
    for name, w, shape in (("w_aux", w_aux, (2 * G, A)), ("w_skip", w_skip, (S, G)),
                           ("w_out", w_out, (R, G))):
        if w.numel() != shape[0] * shape[1] or w.shape[:2] != shape:
            raise ValueError(f"{name} must be {list(shape)} (or with a trailing 1), "
                             f"got {tuple(w.shape)}")
    if skip.dtype != torch.float32:
        raise TypeError(f"skip is the fp32 accumulator, got {skip.dtype}")
    if int(dilation) != dilation or dilation < 1:
        raise ValueError(f"dilation must be an integer >= 1, got {dilation}")
    return B, R, A, S, G, T


def _bias(b: Optional[torch.Tensor], n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.float32, device=like.device) if b is None \
        else b.detach().float()


def wavenet_layer_reference(x, c, skip, w_gate, b_gate, w_aux, w_skip, b_skip, w_out, b_out,
                            dilation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: the dense layer (``pwg.py:87-98``) in fp32 from
    the widened inputs; returns ``(x' in x's type, skip + s in fp32)``."""
    _, R, A, S, G, _ = _shapes(x, c, skip, w_gate, w_aux, w_skip, w_out, dilation)
    xf = x.float()
    h = F.conv1d(xf, w_gate.float(), None if b_gate is None else b_gate.float(),
                 padding=dilation, dilation=dilation)
    h = h + F.conv1d(c.float(), w_aux.float().reshape(2 * G, A, 1))
    z = torch.tanh(h[:, :G]) * torch.sigmoid(h[:, G:])
    s = F.conv1d(z, w_skip.float().reshape(S, G, 1), None if b_skip is None else b_skip.float())
    out = F.conv1d(z, w_out.float().reshape(R, G, 1), None if b_out is None else b_out.float())
    return ((out + xf) * math.sqrt(0.5)).to(x.dtype), skip + s


def pack_weights(w_gate, b_gate, w_aux, w_skip, b_skip, w_out, b_out
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's fp32 operands: ``wk [3R + A, 128]`` (rows tap-major then aux;
    column g < G the tanh half, 64 + g the sigmoid half), ``bg [128]``,
    ``wso [64, 128]`` (row g; column s < S skip, 64 + r out) and ``bso
    [128]``, zero in the padding."""
    G2, R, _ = w_gate.shape
    G, A = G2 // 2, w_aux.shape[1]
    S = w_skip.shape[0]
    f32, dev = torch.float32, w_gate.device
    wg = w_gate.detach().to(f32).permute(2, 1, 0).reshape(3 * R, G2)  # row tap * R + i
    wa = w_aux.detach().to(f32).reshape(G2, A).t()
    wk = torch.zeros(3 * R + A, 2 * HALF, dtype=f32, device=dev)
    for rows, w in ((slice(0, 3 * R), wg), (slice(3 * R, None), wa)):
        wk[rows, :G] = w[:, :G]
        wk[rows, HALF:HALF + G] = w[:, G:]
    bg = torch.zeros(2 * HALF, dtype=f32, device=dev)
    b = _bias(b_gate, G2, w_gate)
    bg[:G], bg[HALF:HALF + G] = b[:G], b[G:]
    wso = torch.zeros(HALF, 2 * HALF, dtype=f32, device=dev)
    wso[:G, :S] = w_skip.detach().to(f32).reshape(S, G).t()
    wso[:G, HALF:HALF + R] = w_out.detach().to(f32).reshape(R, G).t()
    bso = torch.zeros(2 * HALF, dtype=f32, device=dev)
    bso[:S], bso[HALF:HALF + R] = _bias(b_skip, S, w_gate), _bias(b_out, R, w_gate)
    return wk, bg, wso, bso


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("fused_wavenet").vbt_fused_wavenet
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(x, c, skip, w_gate, b_gate, w_aux, w_skip, b_skip, w_out, b_out, dilation
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    B, R, A, S, G, T = _shapes(x, c, skip, w_gate, w_aux, w_skip, w_out, dilation)
    if x.dtype not in (torch.float32, torch.bfloat16) or c.dtype != x.dtype:
        raise TypeError(f"fused_wavenet_layer takes float32 or bfloat16 x and c of one type, "
                        f"got {x.dtype}, {c.dtype}")
    if max(G, S, R) > HALF:
        raise ValueError(f"K5 takes G, S, R <= {HALF}; got G {G}, S {S}, R {R}")
    if B > 65535:
        raise ValueError(f"K5 takes at most 65535 batch rows, got {B}")
    tensors = (x, c, skip, w_gate, w_aux, w_skip, w_out)
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, c, skip and the weights must be on one device")
    if not (x.is_contiguous() and c.is_contiguous() and skip.is_contiguous()):
        raise ValueError("x, c and skip must be contiguous")
    wk, bg, wso, bso = pack_weights(w_gate, b_gate, w_aux, w_skip, b_skip, w_out, b_out)
    x_out, skip_out = torch.empty_like(x), torch.empty_like(skip)
    if x.numel() == 0:
        return x_out, skip_out
    with torch.cuda.device(x.device):
        err = _kernel_fn()(x.data_ptr(), c.data_ptr(), skip.data_ptr(), wk.data_ptr(),
                           bg.data_ptr(), wso.data_ptr(), bso.data_ptr(), x_out.data_ptr(),
                           skip_out.data_ptr(), B, R, A, S, T, int(dilation),
                           int(x.dtype == torch.bfloat16),
                           torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_wavenet launch failed with CUDA error {err}")
    LAUNCHES += 1
    return x_out, skip_out


def fused_wavenet_layer(x: torch.Tensor, c: torch.Tensor, skip: torch.Tensor,
                        w_gate: torch.Tensor, b_gate: Optional[torch.Tensor],
                        w_aux: torch.Tensor, w_skip: torch.Tensor,
                        b_skip: Optional[torch.Tensor], w_out: torch.Tensor,
                        b_out: Optional[torch.Tensor], dilation: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One residual layer; returns ``(x', skip')``.

    x ``[B, R, T]`` and c ``[B, A, T]`` (float32 or bfloat16, one type),
    skip ``[B, S, T]`` fp32, weights in ``nn.Conv1d`` layout (module
    docstring). CUDA tensors go through K5 (fp32 FMA math; G, S, R <= 64),
    CPU tensors through the plain version; other devices raise. ``skip`` is
    not changed: ``skip'`` is a new tensor.
    """
    if x.device.type == "cuda":
        return _launch(x, c, skip, w_gate, b_gate, w_aux, w_skip, b_skip, w_out, b_out, dilation)
    if x.device.type == "cpu":
        return wavenet_layer_reference(x, c, skip, w_gate, b_gate, w_aux, w_skip, b_skip,
                                       w_out, b_out, dilation)
    raise ValueError(f"fused_wavenet_layer runs on cuda or cpu, not {x.device}")
