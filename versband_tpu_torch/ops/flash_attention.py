"""Flash attention: CUDA kernels K1 (forward), K2 and K3 (backward) and
their plain PyTorch versions.

K1 (``csrc/flash_attn_fwd.cu``) replaces
``versband_tpu/ops/flash_attention.py::_attn_kernel``, the Pallas TPU kernel.
It is bound by tensor-core throughput at the serving shape (q/k/v
``[2, 752, 8, 96]`` bf16: ~1,500 FLOP per byte moved, far above the H100's
ridge), so both products run on the tensor cores (``mma.sync`` with fp32
accumulators: bf16 inputs as bf16, fp32 inputs as three TF32 passes over
operands split into a TF32 head and tail), K and V stream through a
``cp.async`` ring and the score matrix never leaves registers; the source's
header has the design.

K2 (dQ) and K3 (dK, dV) (``csrc/flash_attn_bwd.cu``) replace ``_dq_kernel``
and ``_dkv_kernel``: P is recomputed from the forward's log-sum-exp, the row
term ``delta = rowsum(dO * O)`` is computed here in fp32 PyTorch, as the JAX
package leaves it to XLA. Both kernels run all their products on the tensor
cores (``mma.sync``, fp32 accumulators): bf16 inputs as bf16, with P and dS
rounded to bf16 for the second products as K1 rounds P; fp32 inputs as three
TF32 passes per product over operands split into a TF32 head and tail, which
keeps fp32 accuracy. All three kernels load by 16-byte ``cp.async`` copies,
so every row of q, k, v and dO must start on a 16-byte boundary; the
wrappers copy an input whose rows do not. When gradients are needed,
:func:`flash_attention` goes through a ``torch.autograd.Function`` (the counterpart of the JAX
``_flash`` custom VJP) whose forward is K1 and whose backward is K2 + K3, so
gradients flow through the kernels; sampling calls K1 directly.

On a CUDA tensor the wrappers launch the kernels or raise; on a CPU tensor
they run the plain versions (:func:`flash_attention_reference`, the port of
``_sdpa_masked``, and :func:`flash_attention_bwd_reference`, the dense
formulas of the two backward kernels). ``LAUNCHES`` (K1), ``LAUNCHES_DQ``
(K2) and ``LAUNCHES_DKV`` (K3) count kernel launches, so a run can show that
its hot path went through the kernels. :func:`flash_attention_sharded`
runs them on one rank's block of a ``(data, model)`` mesh.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from versband_tpu_torch.ops import _build
from versband_tpu_torch.parallel import copy_to_model, reduce_from_model

LAUNCHES = 0
LAUNCHES_DQ = 0
LAUNCHES_DKV = 0
SUPPORTED_HEAD_DIMS = (32, 64, 96, 128)
_NEG = float(torch.finfo(torch.float32).min)
_FN = None
_BWD_FNS = None


def bind_fwd(lib: ctypes.CDLL):
    """K1's C entry point ``vbt_flash_attn_fwd`` of a loaded library, typed."""
    fn = lib.vbt_flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel_fn():
    global _FN
    if _FN is None:
        _FN = bind_fwd(_build.load("flash_attn_fwd"))
    return _FN


def _bwd_kernel_fns():
    global _BWD_FNS
    if _BWD_FNS is None:
        lib = _build.load("flash_attn_bwd")
        common = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                                       ctypes.c_int, ctypes.c_void_p]
        dq, dkv = lib.vbt_flash_attn_bwd_dq, lib.vbt_flash_attn_bwd_dkv
        dq.argtypes = [ctypes.c_void_p] * 8 + common
        dkv.argtypes = [ctypes.c_void_p] * 9 + common
        dq.restype = dkv.restype = ctypes.c_int
        _BWD_FNS = (dq, dkv)
    return _BWD_FNS


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


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What every kernel takes: q/k/v on one device, one type (float32 or
    bfloat16), a supported head dim."""
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {SUPPORTED_HEAD_DIMS}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kv_len: Optional[torch.Tensor], scale: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    _check_kernel_inputs(q, k, v)
    q, k, v = (_rows_on_16_bytes(t) for t in (q, k, v))  # cp.async reads 16-byte rows
    kv_len = _kv_len_i32(kv_len, q.device)
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
    return _forward(q, k, v, kv_len, scale)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             kv_len: Optional[torch.Tensor], scale: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 or the plain forward by q's device, on inputs already checked."""
    if q.device.type == "cuda":
        return _launch(q, k, v, kv_len, scale)
    if q.device.type == "cpu":
        return _reference_fwd(q, k, v, kv_len, scale)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """The softmax-Jacobian row term rowsum(dO * O), fp32 ``[B, H, Tq]``."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_len: Optional[torch.Tensor], lse: torch.Tensor, delta: torch.Tensor,
           dout: torch.Tensor, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 P = exp(scale q.k - lse), 0 at keys >= kv_len, and dS = P (dP - delta)."""
    B, Tk = q.shape[0], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_len is None:
        kv_len = torch.full((B,), Tk, dtype=torch.int32, device=q.device)
    valid = torch.arange(Tk, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
    p = (s - lse.float()[..., None]).masked_fill(~valid[:, None, None, :], -math.inf).exp()
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_reference(q, k, v, kv_len, lse, delta, dout, scale: float):
    """Plain version of K2 (``_dq_kernel``): dQ = scale * dS K, in q's type."""
    _, ds = _probs(q, k, v, kv_len, lse, delta, dout, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, kv_len, lse, delta, dout, scale: float):
    """Plain version of K3 (``_dkv_kernel``): dK = scale * dS^T Q, dV = P^T dO."""
    p, ds = _probs(q, k, v, kv_len, lse, delta, dout, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  kv_len: Optional[torch.Tensor], out: torch.Tensor,
                                  lse: torch.Tensor, dout: torch.Tensor,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward: delta, then the plain versions of K2 and K3 (the dense
    formulas of ``_dq_kernel`` and ``_dkv_kernel`` in fp32, P recomputed from
    ``lse``; not autograd through the plain forward). Returns (dq, dk, dv)."""
    _check(q, k, v, kv_len)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    delta = _delta(out, dout)
    return (flash_attention_bwd_dq_reference(q, k, v, kv_len, lse, delta, dout, scale),
            *flash_attention_bwd_dkv_reference(q, k, v, kv_len, lse, delta, dout, scale))


def _rows_on_16_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` if 16-byte loads can read its rows (unit-stride head dim, every
    row starting on a 16-byte boundary), else a contiguous copy of it."""
    vec = 16 // t.element_size()
    if t.stride(3) == 1 and not any(s % vec for s in t.stride()[:3]) \
            and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _bwd_kernel_args(q, k, v, kv_len, lse, delta, dout, scale):
    """Check what K2 and K3 take; return q, k, v and dout (in q's type) as
    the kernels can load them, kv_len's pointer, and the common arguments
    after the pointers."""
    _check_kernel_inputs(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a unit-stride head dim; got {t.stride()}")
    B, Tq, H, D = q.shape
    for t in (lse, delta, dout):
        if t.device != q.device:
            raise ValueError("lse, delta and dout must be on q's device")
    for t in (lse, delta):
        if t.shape != (B, H, Tq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"lse and delta must be contiguous float32 [B, H, Tq] = "
                             f"{[B, H, Tq]}, got {tuple(t.shape)} {t.dtype}")
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} must have q's shape {tuple(q.shape)}")
    if kv_len is not None and tuple(kv_len.shape) != (B,):
        raise ValueError(f"kv_len must be [B]={B}, got {tuple(kv_len.shape)}")
    q, k, v, dout = (_rows_on_16_bytes(t) for t in (q, k, v, dout.to(q.dtype)))
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *dout.stride()[:3])
    kv_ptr = None if kv_len is None else kv_len.data_ptr()
    return (q, k, v, dout), kv_ptr, (B, Tq, k.shape[1], H, D, strides, scale,
                                     int(q.dtype == torch.bfloat16))


def _kv_len_i32(kv_len: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    return None if kv_len is None else kv_len.to(device=device, dtype=torch.int32).contiguous()


def flash_attention_bwd_dq(q, k, v, kv_len, lse, delta, dout, scale: float) -> torch.Tensor:
    """dQ: K2 on CUDA tensors, its plain version on CPU tensors."""
    global LAUNCHES_DQ
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, kv_len, lse, delta, dout, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    kv_len = _kv_len_i32(kv_len, q.device)
    tensors, kv_ptr, args = _bwd_kernel_args(q, k, v, kv_len, lse, delta, dout, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return dq
    with torch.cuda.device(q.device):
        err = _bwd_kernel_fns()[0](*(t.data_ptr() for t in tensors), kv_ptr, lse.data_ptr(),
                                   delta.data_ptr(), dq.data_ptr(), *args,
                                   torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd dq launch failed with CUDA error {err}")
    LAUNCHES_DQ += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, kv_len, lse, delta, dout, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV): K3 on CUDA tensors, its plain version on CPU tensors."""
    global LAUNCHES_DKV
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, kv_len, lse, delta, dout, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    kv_len = _kv_len_i32(kv_len, q.device)
    tensors, kv_ptr, args = _bwd_kernel_args(q, k, v, kv_len, lse, delta, dout, scale)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    if k.numel() == 0:
        return dk, dv
    if q.numel() == 0:
        return dk.zero_(), dv.zero_()
    with torch.cuda.device(q.device):
        err = _bwd_kernel_fns()[1](*(t.data_ptr() for t in tensors), kv_ptr, lse.data_ptr(),
                                   delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *args,
                                   torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd dkv launch failed with CUDA error {err}")
    LAUNCHES_DKV += 1
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[torch.Tensor], out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of :func:`flash_attention` for the upstream
    gradient ``dout``, from the forward's ``out`` and ``lse``: delta in fp32
    PyTorch, then :func:`flash_attention_bwd_dq` (K2) and
    :func:`flash_attention_bwd_dkv` (K3), which run the kernels on CUDA
    tensors and their plain versions on CPU tensors; other devices raise.
    """
    _check(q, k, v, kv_len)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must have "
                         f"q's shape {tuple(q.shape)}")
    if out.device != q.device or dout.device != q.device or lse.device != q.device:
        raise ValueError("out, lse and dout must be on q's device")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    lse = lse.float().contiguous()
    delta = _delta(out, dout)
    dq = flash_attention_bwd_dq(q, k, v, kv_len, lse, delta, dout, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, kv_len, lse, delta, dout, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 + K3 backward (the JAX package's ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, scale):
        out, lse = _forward(q, k, v, kv_len, scale)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, kv_len, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_len, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_len, out, lse, dout, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention_fwd`` without the log-sum-exp, differentiable: when
    autograd records and q, k or v requires grad, the call goes through
    ``_FlashAttention``, whose backward runs :func:`flash_attention_bwd` (K2
    and K3 on CUDA tensors); otherwise (sampling) straight to the forward."""
    _check(q, k, v, kv_len)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_len, scale)
    return _forward(q, k, v, kv_len, scale)[0]


def flash_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kv_len: Optional[torch.Tensor] = None, mesh=None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_attention` under a ``(data, model)`` mesh (the port of
    the JAX ``flash_attention_sharded``): q, k, v are whole ``[B, T, H, D]``
    on every rank of ``mesh`` (a ``parallel.mesh.Mesh``); each rank runs K1
    on its ``[B/d, T, H/m, D]`` block (its data index's rows, its model
    index's heads), and the whole output comes back by one all-reduce of a
    zero tensor holding each rank's block. The gradient runs K2/K3 on the
    same block and comes back whole the same way. Axes that do not divide
    (``B % d``, ``H % m``), a mesh of one rank, or no mesh: the unsharded
    kernel, as in JAX."""
    if mesh is None or mesh.size == 1:
        return flash_attention(q, k, v, kv_len=kv_len, scale=scale)
    B, H = q.shape[0], q.shape[2]
    if B % mesh.n_data or H % mesh.n_model:
        return flash_attention(q, k, v, kv_len=kv_len, scale=scale)
    bl, hl = B // mesh.n_data, H // mesh.n_model
    rows = slice(mesh.data_rank * bl, (mesh.data_rank + 1) * bl)
    heads = slice(mesh.model_rank * hl, (mesh.model_rank + 1) * hl)
    q, k, v = (copy_to_model(t, mesh.group)[rows, :, heads] for t in (q, k, v))
    out = flash_attention(q, k, v, kv_len=None if kv_len is None else kv_len[rows],
                          scale=scale)
    whole = out.new_zeros(B, out.shape[1], H, out.shape[3])
    whole[rows, :, heads] = out
    return reduce_from_model(whole, mesh.group)
