"""Host-side collate helpers (port of ``versband_tpu/data/collate.py``; numpy).

``collate_1d``/``collate_2d`` and the ``_tile`` variants pad or tile each item
to the batch length: the longest item, clamped to [``min_len``, ``max_len``]
(the floor applied last, so it wins) and rounded up to a multiple of
``min_factor``. ``pad_or_cut_xd`` pads with ``pad_value`` or truncates along
``dim`` to an exact length.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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


def _target_size(sizes: Sequence[int], min_len: Optional[int],
                 max_len: Optional[int], min_factor: Optional[int]) -> int:
    size = max(sizes)
    if max_len:
        size = min(size, max_len)
    if min_len:
        size = max(size, min_len)
    if min_factor and size % min_factor:
        size += min_factor - size % min_factor
    return size


def collate_1d(values: Sequence[np.ndarray], pad_idx: float = 0.0,
               left_pad: bool = False, shift_right: bool = False,
               min_len: Optional[int] = None, max_len: Optional[int] = None,
               min_factor: Optional[int] = None, shift_id: int = 1) -> np.ndarray:
    """List of [T_i] -> [B, T] padded with pad_idx."""
    size = _target_size([len(v) for v in values], min_len, max_len, min_factor)
    res = np.full((len(values), size), pad_idx, np.float32)
    for i, v in enumerate(values):
        v = np.asarray(v, np.float32)[:size]
        if shift_right:
            dst = np.concatenate([[shift_id], v[:-1]])
        else:
            dst = v
        if left_pad:
            res[i, size - len(dst):] = dst
        else:
            res[i, : len(dst)] = dst
    return res


def collate_2d(values: Sequence[np.ndarray], pad_idx: float = 0.0,
               left_pad: bool = False, shift_right: bool = False,
               min_len: Optional[int] = None, max_len: Optional[int] = None,
               min_factor: Optional[int] = None) -> np.ndarray:
    """List of [C, T_i] -> [B, C, T] padded along time with pad_idx."""
    size = _target_size([v.shape[1] for v in values], min_len, max_len,
                        min_factor)
    C = values[0].shape[0]
    res = np.full((len(values), C, size), pad_idx, np.float32)
    for i, v in enumerate(values):
        v = np.asarray(v, np.float32)[:, :size]
        if left_pad:
            res[i, :, size - v.shape[1]:] = v
        else:
            res[i, :, : v.shape[1]] = v
    return res


def collate_1d_or_2d(values, pad_idx=0.0, left_pad=False, shift_right=False,
                     min_len=None, max_len=None, min_factor=None, shift_id=1):
    if np.asarray(values[0]).ndim == 1:
        return collate_1d(values, pad_idx, left_pad, shift_right, min_len,
                          max_len, min_factor, shift_id)
    return collate_2d(values, pad_idx, left_pad, shift_right, min_len,
                      max_len, min_factor)


def _tile_to(v: np.ndarray, size: int, axis: int) -> np.ndarray:
    reps = [1] * v.ndim
    reps[axis] = math.ceil(size / v.shape[axis])
    tiled = np.tile(v, reps)
    sl = [slice(None)] * v.ndim
    sl[axis] = slice(0, size)
    return tiled[tuple(sl)]


def collate_1d_tile(values, shift_right=False, min_len=None, max_len=None,
                    min_factor=None, shift_id=1) -> np.ndarray:
    size = _target_size([len(v) for v in values], min_len, max_len, min_factor)
    res = np.stack([_tile_to(np.asarray(v, np.float32), size, 0)
                    for v in values])
    if shift_right:
        res = np.concatenate([np.full((len(values), 1), shift_id, np.float32),
                              res[:, :-1]], axis=1)
    return res


def collate_2d_tile(values, shift_right=False, min_len=None, max_len=None,
                    min_factor=None) -> np.ndarray:
    size = _target_size([v.shape[1] for v in values], min_len, max_len,
                        min_factor)
    return np.stack([_tile_to(np.asarray(v, np.float32), size, 1)
                     for v in values])


def collate_1d_or_2d_tile(values, shift_right=False, min_len=None,
                          max_len=None, min_factor=None, shift_id=1):
    if np.asarray(values[0]).ndim == 1:
        return collate_1d_tile(values, shift_right, min_len, max_len,
                               min_factor, shift_id)
    return collate_2d_tile(values, shift_right, min_len, max_len, min_factor)
