"""Host-side collate helper (the port's own copy of ``pad_or_cut_xd`` from
``versband_tpu/data/collate.py``; numpy)."""

from __future__ import annotations

import numpy as np


def pad_or_cut_xd(x: np.ndarray, length: int, dim: int = 1,
                  pad_value: float = 0.0) -> np.ndarray:
    """Pad (right, with pad_value) or truncate ``x`` to ``length`` along ``dim``."""
    x = np.asarray(x)
    cur = x.shape[dim]
    if cur == length:
        return x
    if cur > length:
        sl = [slice(None)] * x.ndim
        sl[dim] = slice(0, length)
        return x[tuple(sl)]
    pad = [(0, 0)] * x.ndim
    pad[dim] = (0, length - cur)
    return np.pad(x, pad, constant_values=pad_value)
