"""Fused gated-WaveNet residual layer: CUDA kernel K5 and its plain version.

One ParallelWaveGAN residual layer (port of ``versband_tpu/ops/fused_wavenet.py``;
reference ``parallel_wavegan/layers/residual_block.py:39-130``), per sample t:

    gate  = W_g0 x[t-d] + W_g1 x[t] + W_g2 x[t+d] + W_c c[t] + b_g   # [2G]
    z     = tanh(gate[:G]) * sigmoid(gate[G:])                        # [G]
    skip' = skip + W_s z + b_s                                        # [S], fp32
    x'    = (W_o z + b_o + x[t]) * sqrt(0.5)                          # [R]

with x zero outside the sequence. K5 (``csrc/fused_wavenet.cu``) replaces
``_layer_kernel``, the Pallas TPU kernel: one pass per layer, the gate and z
never leave the chip; the source's header has the design. Its products run
on the tensor cores as three TF32 passes (fp32-accurate), which bound it. It
takes any T and any dilation >= 1: the TPU kernel's block grid, ``t_real``
tail and ``D_HALO = 512`` dilation limit have no counterpart. Its weights are
packed in ``mma`` fragment order (:func:`pack_weights`) once per layer: the
caller passes the layer's :class:`PackCache` (``ResidualBlock`` keeps one).

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
MAX_K = 288  # 3R + A: the gate weights K5 holds in shared memory
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


def pack_matrices(w_gate, b_gate, w_aux, w_skip, b_skip, w_out, b_out
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's two A operands as fp32 matrices, before fragment order.

    ``wg [128, K8]``: the gate rows, m-tile by m-tile (16 rows each): row
    ``16 m + r`` is the tanh row of gate unit ``8 m + r`` for ``r < 8`` and
    the sigmoid row of unit ``8 m + r - 8`` otherwise; columns are the X rows
    tap-major (``tap * R + i``: x at t - d, t, t + d) then the aux rows,
    zero-padded to ``K8``, a multiple of 8. ``bg [128]`` in the same row
    order. ``wso [128, 64]``: rows ``s < S`` skip, ``64 + r`` out; column the
    gate unit. ``bso [128]``. Units past G, channels past S or R are zero.
    """
    G2, R, _ = w_gate.shape
    G, A = G2 // 2, w_aux.shape[1]
    S = w_skip.shape[0]
    K = 3 * R + A
    f32, dev = torch.float32, w_gate.device
    cols = torch.cat([w_gate.detach().to(f32).permute(0, 2, 1).reshape(G2, 3 * R),
                      w_aux.detach().to(f32).reshape(G2, A)], dim=1)  # [2G, K]
    b = _bias(b_gate, G2, w_gate)
    unit = torch.arange(G, device=dev)
    tanh_row = 16 * (unit // 8) + unit % 8  # packed row of each unit's tanh row
    rows = torch.cat([tanh_row, tanh_row + 8])  # then its sigmoid row; gate rows in order
    wg = torch.zeros(2 * HALF, -(-K // 8) * 8, dtype=f32, device=dev)
    bg = torch.zeros(2 * HALF, dtype=f32, device=dev)
    wg[rows, :K] = cols
    bg[rows] = b
    wso = torch.zeros(2 * HALF, HALF, dtype=f32, device=dev)
    wso[:S, :G] = w_skip.detach().to(f32).reshape(S, G)
    wso[HALF:HALF + R, :G] = w_out.detach().to(f32).reshape(R, G)
    bso = torch.zeros(2 * HALF, dtype=f32, device=dev)
    bso[:S], bso[HALF:HALF + R] = _bias(b_skip, S, w_gate), _bias(b_out, R, w_gate)
    return wg, bg, wso, bso


def fragment_order(w: torch.Tensor) -> torch.Tensor:
    """``[16 M, 8 K]`` -> ``[M, K, 32, 4]``: per 16 x 8 tile the four values
    each lane of an ``mma.sync`` m16n8k8 TF32 A operand holds, lane ``4 g +
    t`` holding rows g, g + 8 at column t, then rows g, g + 8 at column t + 4."""
    M, K = w.shape[0] // 16, w.shape[1] // 8
    return w.reshape(M, 2, 8, K, 2, 4).permute(0, 3, 2, 5, 4, 1).reshape(M, K, 32, 4)


def pack_weights(w_gate, b_gate, w_aux, w_skip, b_skip, w_out, b_out
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's fp32 operands: the gate and skip/out matrices of
    :func:`pack_matrices` in fragment order, ``[8, K8 / 8, 32, 4]`` and
    ``[8, 8, 32, 4]``, and their biases ``[128]``."""
    wg, bg, wso, bso = pack_matrices(w_gate, b_gate, w_aux, w_skip, b_skip, w_out, b_out)
    return (fragment_order(wg).contiguous(), bg, fragment_order(wso).contiguous(), bso)


def _weight_key(w: Optional[torch.Tensor]):
    if w is None:
        return None
    # An inference tensor has no version counter: it is keyed on its storage
    # alone, so an in-place change made to it inside inference mode is not seen.
    version = None if w.is_inference() else w._version
    return w.data_ptr(), version, w.dtype, tuple(w.shape)


class PackCache:
    """K5's packed weights of one layer, made again only when a weight
    changes: when its storage (``data_ptr``) or its in-place version
    (``_version``) differs from the last call's. So ``load_state_dict``,
    ``.to()`` and in-place updates are seen. The weights last packed are held,
    so their storage cannot be freed and its address given to new ones."""

    def __init__(self):
        self._key = None
        self._held: tuple = ()
        self.packed: Optional[Tuple[torch.Tensor, ...]] = None

    def get(self, *weights) -> Tuple[torch.Tensor, ...]:
        key = tuple(_weight_key(w) for w in weights)
        if self.packed is None or key != self._key:
            self.packed = pack_weights(*weights)
            self._key = key
            self._held = tuple(None if w is None else w.detach() for w in weights)
        return self.packed


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("fused_wavenet").vbt_fused_wavenet
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def smem_bytes(R: int, A: int, dtype: torch.dtype) -> int:
    """K5's shared memory per block at these widths (asked of the built
    library)."""
    fn = _build.load("fused_wavenet").vbt_fused_wavenet_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(R, A, int(dtype == torch.bfloat16))


def _launch(x, c, skip, w_gate, b_gate, w_aux, w_skip, b_skip, w_out, b_out, dilation,
            pack_cache: PackCache) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    B, R, A, S, G, T = _shapes(x, c, skip, w_gate, w_aux, w_skip, w_out, dilation)
    if x.dtype not in (torch.float32, torch.bfloat16) or c.dtype != x.dtype:
        raise TypeError(f"fused_wavenet_layer takes float32 or bfloat16 x and c of one type, "
                        f"got {x.dtype}, {c.dtype}")
    if max(G, S, R) > HALF:
        raise ValueError(f"K5 takes G, S, R <= {HALF}; got G {G}, S {S}, R {R}")
    if 3 * R + A > MAX_K:
        raise ValueError(f"K5 takes 3R + A <= {MAX_K}; got R {R}, A {A}")
    tensors = (x, c, skip, w_gate, w_aux, w_skip, w_out)
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, c, skip and the weights must be on one device")
    if not (x.is_contiguous() and c.is_contiguous() and skip.is_contiguous()):
        raise ValueError("x, c and skip must be contiguous")
    wg, bg, wso, bso = pack_cache.get(w_gate, b_gate, w_aux, w_skip, b_skip, w_out, b_out)
    x_out, skip_out = torch.empty_like(x), torch.empty_like(skip)
    if x.numel() == 0:
        return x_out, skip_out
    with torch.cuda.device(x.device):
        err = _kernel_fn()(x.data_ptr(), c.data_ptr(), skip.data_ptr(), wg.data_ptr(),
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
                        b_out: Optional[torch.Tensor], dilation: int, pack_cache: PackCache
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One residual layer; returns ``(x', skip')``.

    x ``[B, R, T]`` and c ``[B, A, T]`` (float32 or bfloat16, one type),
    skip ``[B, S, T]`` fp32, weights in ``nn.Conv1d`` layout (module
    docstring). CUDA tensors go through K5 (fp32-accurate products on the
    tensor cores; G, S, R <= 64, 3R + A <= 288), with the packed weights
    that ``pack_cache``, this layer's cache, holds or makes; CPU tensors
    through the plain version (``pack_cache`` unused); other devices raise.
    ``skip`` is not changed: ``skip'`` is a new tensor.
    """
    if x.device.type == "cuda":
        return _launch(x, c, skip, w_gate, b_gate, w_aux, w_skip, b_skip, w_out, b_out, dilation,
                       pack_cache)
    if x.device.type == "cpu":
        return wavenet_layer_reference(x, c, skip, w_gate, b_gate, w_aux, w_skip, b_skip,
                                       w_out, b_out, dilation)
    raise ValueError(f"fused_wavenet_layer runs on cuda or cpu, not {x.device}")
