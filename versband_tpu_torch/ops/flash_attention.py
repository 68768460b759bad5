"""Flash-attention forward: CUDA kernel K1 and its plain PyTorch version.

K1 (``csrc/flash_attn_fwd.cu``) replaces
``versband_tpu/ops/flash_attention.py::_attn_kernel``, the Pallas TPU kernel.
It is bound by tensor-core throughput at the serving shape (q/k/v
``[2, 752, 8, 96]`` bf16: ~1,500 FLOP per byte moved, far above the H100's
ridge), so both products run on the tensor cores (``mma.sync`` bf16, fp32
accumulate) and the score matrix never leaves registers; the source's header
has the design.

On a CUDA tensor the wrappers launch K1 or raise; on a CPU tensor they run
:func:`flash_attention_reference`, the port of ``_sdpa_masked``. ``LAUNCHES``
counts kernel launches, so a run can show the hot path went through K1.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from versband_tpu_torch.ops import _build

LAUNCHES = 0
SUPPORTED_HEAD_DIMS = (32, 64, 96, 128)
_NEG = float(torch.finfo(torch.float32).min)
_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("flash_attn_fwd").vbt_flash_attn_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_len: Optional[torch.Tensor]) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be [B, T, H, D]")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if kv_len is not None and tuple(kv_len.shape) != (B,):
        raise ValueError(f"kv_len must be [B]={B}, got {tuple(kv_len.shape)}")


def _reference_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: Optional[torch.Tensor], scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense masked attention in fp32; returns (out in q's dtype, lse fp32 [B,H,Tq])."""
    B, _, _, _ = q.shape
    Tk = k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_len is None:
        kv_len = torch.full((B,), Tk, dtype=torch.int32, device=q.device)
    kv_len = kv_len.to(device=q.device, dtype=torch.int32)
    valid = torch.arange(Tk, device=q.device)[None, :] < kv_len[:, None]  # [B, Tk]
    logits = logits.masked_fill(~valid[:, None, None, :], _NEG)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    out = out.masked_fill((kv_len <= 0)[:, None, None, None], 0.0)
    return out.to(q.dtype), lse


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              kv_len: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K1: fp32 logits, softmax and P.V; keys ``>= kv_len``
    masked; ``kv_len == 0`` rows are 0 (``versband_tpu``'s ``_sdpa_masked``)."""
    _check(q, k, v, kv_len)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _reference_fwd(q, k, v, kv_len, scale)[0]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kv_len: Optional[torch.Tensor], scale: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {SUPPORTED_HEAD_DIMS}")
    vec = 16 // q.element_size()  # elements per 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} must have a unit-stride head dim and "
                             f"16-byte aligned rows; got strides {t.stride()}")
    if kv_len is not None:
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if kv_len is None else kv_len.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), B, Tq, Tk, H, D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 scale, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked attention over ``[B, T, H, D]`` tensors; returns ``(out, lse)``.

    ``kv_len``: [B] valid key counts (default: all keys). ``out`` has q's type;
    ``lse`` is the fp32 log-sum-exp of the scaled logits, ``[B, H, Tq]``,
    finite for fully masked rows. CUDA tensors go through K1, CPU tensors
    through the plain version; other devices raise.
    """
    _check(q, k, v, kv_len)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if q.device.type == "cuda":
        return _launch(q, k, v, kv_len, scale)
    if q.device.type == "cpu":
        return _reference_fwd(q, k, v, kv_len, scale)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention_fwd`` without the log-sum-exp."""
    return flash_attention_fwd(q, k, v, kv_len, scale)[0]
