"""ITU-R BS.1770 loudness measurement and normalisation (the port's own copy
of ``versband_tpu/dsp/loudness.py``; scipy's ``lfilter`` only).

K-weighting (a high-shelf and a high-pass biquad designed for the sample
rate), 400 ms blocks with 75 % overlap, a -70 LUFS absolute gate and a
-10 LU relative gate. ``normalize_loudness(wav, -23)`` is the inference
CLI's loudness step (reference ``scripts/test_final.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from scipy.signal import lfilter

from versband_tpu_torch.utils.profiling import annotate


def _k_weighting_coeffs(sr: float) -> Tuple[Tuple[np.ndarray, np.ndarray],
                                            Tuple[np.ndarray, np.ndarray]]:
    """BS.1770-4 pre-filter (high shelf) + RLB high-pass for sample rate sr."""
    # stage 1: spherical-head high shelf
    db = 3.999843853973347
    f0 = 1681.974450955533
    Q = 0.7071752369554196
    K = math.tan(math.pi * f0 / sr)
    Vh = 10 ** (db / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b = np.array([(Vh + Vb * K / Q + K * K) / a0,
                  2.0 * (K * K - Vh) / a0,
                  (Vh - Vb * K / Q + K * K) / a0])
    a = np.array([1.0, 2.0 * (K * K - 1.0) / a0,
                  (1.0 - K / Q + K * K) / a0])
    # stage 2: RLB high pass
    f0 = 38.13547087602444
    Q = 0.5003270373238773
    K = math.tan(math.pi * f0 / sr)
    a2 = np.array([1.0,
                   2.0 * (K * K - 1.0) / (1.0 + K / Q + K * K),
                   (1.0 - K / Q + K * K) / (1.0 + K / Q + K * K)])
    b2 = np.array([1.0, -2.0, 1.0])
    return (b, a), (b2, a2)


def integrated_loudness(wav: np.ndarray, sr: int = 24000) -> float:
    """Gated integrated loudness (LUFS) of a mono (or [T, C]) signal."""
    x = np.asarray(wav, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    (b1, a1), (b2, a2) = _k_weighting_coeffs(sr)
    y = lfilter(b2, a2, lfilter(b1, a1, x, axis=0), axis=0)

    block = int(0.4 * sr)
    hop = block // 4
    if y.shape[0] < block:
        ms = np.mean(y ** 2, axis=0).sum()
        return -0.691 + 10 * math.log10(max(ms, 1e-12))
    n_blocks = 1 + (y.shape[0] - block) // hop
    idx = np.arange(block)[None, :] + hop * np.arange(n_blocks)[:, None]
    # per-block mean square, channels summed (mono weights = 1)
    z = (y[idx] ** 2).mean(axis=1).sum(axis=-1)  # [n_blocks]
    lk = -0.691 + 10 * np.log10(np.maximum(z, 1e-12))

    gated = z[lk > -70.0]
    if gated.size == 0:
        return -70.0
    rel_threshold = -0.691 + 10 * math.log10(max(gated.mean(), 1e-12)) - 10.0
    final = z[(lk > -70.0) & (lk > rel_threshold)]
    if final.size == 0:
        return -70.0
    return -0.691 + 10 * math.log10(max(final.mean(), 1e-12))


def normalize_loudness(wav: np.ndarray, target_lufs: float = -23.0,
                       sr: int = 24000, max_gain_db: Optional[float] = None,
                       peak_limit: float = 1.0) -> np.ndarray:
    """Scale ``wav`` to the target integrated loudness; optional gain cap
    (the preprocess pipeline caps at +/-20 dB, ``mel_spec_24k.py:42-43``) and
    peak clamp."""
    with annotate("dsp.normalize_loudness"):
        loud = integrated_loudness(wav, sr)
        gain_db = target_lufs - loud
        if max_gain_db is not None:
            gain_db = float(np.clip(gain_db, -max_gain_db, max_gain_db))
        out = np.asarray(wav, np.float32) * (10 ** (gain_db / 20.0))
        peak = np.abs(out).max() if out.size else 0.0
        if peak_limit and peak > peak_limit:
            out = out / peak * peak_limit
        return out
