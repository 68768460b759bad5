"""WAV reading, resampling and writing on scipy (the port's copy of
``versband_tpu/dsp/audio_io.py`` and of ``write_wav`` in
``versband_tpu/cli/generate.py:136-145``).

``load_wav`` decodes int16, int32, uint8 and float payloads to float32 in
[-1, 1], averages the channels to mono and resamples with ``resample_poly``
by the gcd ratio of the two rates: the read side of the data-preparation
CLIs (reference ``preprocess/mel_spec_24k.py``).
"""

from __future__ import annotations

import math
import os
import wave
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str, target_sr: Optional[int] = None,
             mono: bool = True) -> Tuple[np.ndarray, int]:
    """The float32 waveform in [-1, 1] and its sample rate (``target_sr``
    where one is given)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if mono and wav.ndim > 1:
        wav = wav.mean(axis=1)
    if target_sr and sr != target_sr:
        g = math.gcd(int(sr), int(target_sr))
        wav = resample_poly(wav, target_sr // g, sr // g).astype(np.float32)
        sr = target_sr
    return wav, sr


def save_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """16-bit PCM of ``wav`` clipped to [-1, 1], into an existing directory."""
    wav = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767).astype(np.int16))


def get_wav_num_frames(path: str, target_sr: Optional[int] = None) -> int:
    """The frame count, at ``target_sr`` where one is given, from the header
    alone (``wave``: PCM files only, as in the JAX package)."""
    with wave.open(path, "rb") as f:
        n, sr = f.getnframes(), f.getframerate()
    if target_sr and sr != target_sr:
        return int(round(n * target_sr / sr))
    return n


def safe_path(path: str) -> str:
    """``path``, with its directory made."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return path


def write_wav(path: str, wav: np.ndarray, sr: int = 24000) -> None:
    """:func:`save_wav`, with the file's directory made."""
    save_wav(safe_path(path), wav, sr)
