"""Roofline, busy-time and rate arithmetic of the benchmark.

Frozen copies, so that a change to the program cannot move the yardstick:

* ``PEAK_FLOPS``, ``PEAK_BYTES``, ``PEAK_FP32_PRODUCT``, ``bound_ms``,
  ``k1_bound_ms`` and ``bwd_bound_ms`` are ``chip_smoke.py``'s (H100 SXM
  data-sheet peaks, dense; an fp32-accurate product may run as three TF32
  passes, so its peak is max(67, 495 / 3) TFLOP/s), taking shapes instead
  of tensors;
* ``busy_s`` is ``profile_serving.py::busy_ms`` (the length of the union of
  the device operations' intervals), in seconds of nanosecond stamps.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
PEAK_FP32_PRODUCT = max(PEAK_FLOPS["float32"], PEAK_FLOPS["tf32"] / 3)
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_ms(flops: float, nbytes: float, dtype: str = "float32",
             products: bool = False) -> Tuple[float, str]:
    """Least time on the card: the larger of FLOPs over the peak rate of
    ``dtype`` and bytes over HBM, and which of the two bounds it."""
    peak = PEAK_FP32_PRODUCT if products and dtype == "float32" else PEAK_FLOPS[dtype]
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound_ms(B: int, Tq: int, Tk: int, H: int, D: int, dtype: str,
                valid_keys: int = None, products: bool = True) -> Tuple[float, str]:
    """The attention forward's bound: 4 FLOP per (query, valid key, dim); q,
    k, v read once, out and the fp32 log-sum-exp written once."""
    keys = Tk * B if valid_keys is None else valid_keys
    flops = 4 * H * Tq * keys * D
    e = ELEMENT_BYTES[dtype]
    nbytes = (2 * B * Tq * H * D + 2 * B * Tk * H * D) * e + B * H * Tq * 4
    return bound_ms(flops, nbytes, dtype, products)


def bwd_bound_ms(B: int, Tq: int, Tk: int, H: int, D: int, dtype: str, kernel: str,
                 valid_keys: int = None, products: bool = True) -> Tuple[float, str]:
    """The attention backward's bound, dQ ("dq": 6 FLOP per (query, valid
    key, dim)) or dK/dV ("dkv": 8); q, k, v, dO, lse and delta read once,
    the gradients written once."""
    keys = Tk * B if valid_keys is None else valid_keys
    flops = (6 if kernel == "dq" else 8) * H * Tq * keys * D
    e = ELEMENT_BYTES[dtype]
    q_n, k_n = B * Tq * H * D, B * Tk * H * D
    nbytes = (2 * q_n + 2 * k_n) * e + 2 * B * H * Tq * 4
    nbytes += q_n * e if kernel == "dq" else 2 * k_n * e
    return bound_ms(flops, nbytes, dtype, products)


def busy_s(intervals: Iterable[Tuple[int, int]]) -> float:
    """Length in seconds of the union of ``[start, end)`` nanosecond intervals."""
    total, end = 0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e9


def union(intervals: Iterable[Tuple[int, int]]) -> list:
    """The union of ``[start, end)`` intervals as sorted disjoint intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 < q < 100) by linear interpolation between
    order statistics (``statistics.quantiles(method="inclusive")``)."""
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def rate(count: int, seconds: float) -> float:
    """Work completed per second of the window."""
    return count / seconds

