"""WAV writing for the inference CLI (the port's copy of ``write_wav`` in
``versband_tpu/cli/generate.py:136-145``, on ``scipy.io.wavfile``)."""

from __future__ import annotations

import os

import numpy as np
from scipy.io import wavfile


def safe_path(path: str) -> str:
    """``path``, with its directory made."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return path


def write_wav(path: str, wav: np.ndarray, sr: int = 24000) -> None:
    """16-bit PCM of ``wav`` clipped to [-1, 1]."""
    wav = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    wavfile.write(safe_path(path), sr, (wav * 32767).astype(np.int16))
