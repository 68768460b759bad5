"""Log-mel front end (port of ``versband_tpu/dsp/mel.py``).

The reference's MelNet (``preprocess/NAT_mel.py:42-86``) with the canonical
constants of ``preprocess/mel_spec_24k.py:300-316``: 24 kHz, 80 mels,
n_fft 1280, win 1280, hop 320, fmin 0, fmax 8000, periodic Hann window,
``center=False`` after a reflect pad of ``(n_fft - hop) / 2``, magnitude
``sqrt(re^2 + im^2 + 1e-9)``, Slaney mel filterbank and
``log10(clamp(x, 1e-5))``.

The STFT is a framed matmul against windowed cos/sin bases by default (the
JAX package's path), or ``torch.fft.rfft`` with ``use_fft=True``. Both run on
the tensors' device: ``MelSpectrogram`` moves its constants to the input's
device, so it serves as the HiFi-GAN recipe's ``mel_fn`` on the card. The
numpy pieces (``mel_filterbank``, ``hann_window``) are the port's own copies.

:func:`reflect_pad` is the reflect pad of ``jnp.pad``/``numpy.pad``, which
keeps folding when the pad is as long as the signal or longer, where torch's
``F.pad(mode="reflect")`` raises; the mel, the MR-STFT loss and the MPD and
MRD discriminators pad through it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

MAX_WAV_VALUE = 32768.0


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 24000
    n_mels: int = 80
    n_fft: int = 1280
    win_size: int = 1280
    hop_size: int = 320
    fmin: float = 0.0
    fmax: float = 8000.0
    clip_val: float = 1e-5

    @property
    def pad(self) -> int:
        return (self.n_fft - self.hop_size) // 2

    @classmethod
    def from_hparams(cls, hparams: dict) -> "MelConfig":
        """From the reference's hparam names (``mel_spec_24k.py:300-316``)."""
        return cls(sample_rate=hparams.get("audio_sample_rate", 24000),
                   n_mels=hparams.get("audio_num_mel_bins", 80),
                   n_fft=hparams.get("fft_size", 1280),
                   win_size=hparams.get("win_size", 1280),
                   hop_size=hparams.get("hop_size", 320),
                   fmin=hparams.get("fmin", 0.0),
                   fmax=hparams.get("fmax", 8000.0))


DEFAULT_MEL_CONFIG = MelConfig()


def _hz_to_mel(f) -> np.ndarray:
    """Slaney mel scale (librosa's default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz, logstep = 1000.0, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz, logstep = 1000.0, np.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalised triangular filters ``[n_mels, 1 + n_fft // 2]``
    (``librosa.filters.mel`` with htk=False, norm='slaney')."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, dtype=np.float64)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def hann_window(win_size: int) -> np.ndarray:
    """Periodic Hann window (``torch.hann_window``'s default)."""
    n = np.arange(win_size, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)).astype(np.float32)


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """``x`` padded on its last axis by reflection without the edge sample,
    ``numpy.pad(mode="reflect")``'s folding for any pad length: the signal
    repeats with period ``2 (n - 1)`` (a one-sample signal repeats itself).
    A gather on ``x``'s device, so autograd goes through it."""
    n = x.shape[-1]
    if left == right == 0:
        return x
    if n == 0:
        raise ValueError("cannot reflect-pad an empty signal")
    idx = torch.arange(-left, n + right, device=x.device)
    if n == 1:
        idx = torch.zeros_like(idx)
    else:
        period = 2 * (n - 1)
        idx = torch.remainder(idx, period)
        idx = torch.where(idx >= n, period - idx, idx)
    return x.index_select(-1, idx)


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0,
                              clip_val: float = 1e-5) -> torch.Tensor:
    return torch.log10(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x: torch.Tensor, C: float = 1.0) -> torch.Tensor:
    return torch.pow(10.0, x) / C


def dft_bases(window: np.ndarray, n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases ``(cos, -sin)``, each ``[n_fft, 1 + n_fft // 2]``."""
    k = np.arange(1 + n_fft // 2)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    w = np.asarray(window, np.float32)[:, None]
    return np.cos(ang).astype(np.float32) * w, (-np.sin(ang)).astype(np.float32) * w


def stft_magnitude(y: torch.Tensor, window: torch.Tensor, n_fft: int, hop_size: int,
                   use_fft: bool = False, bases=None) -> torch.Tensor:
    """``sqrt(|X|^2 + 1e-9)`` of pre-padded audio ``[B, L]`` -> ``[B, 1 + n_fft // 2, T]``
    (``center=False`` frames). ``bases``: ``dft_bases`` as tensors on y's
    device (made here when not given) for the matmul path."""
    frames = y.unfold(-1, n_fft, hop_size)  # [B, T, n_fft]
    if use_fft:
        spec = torch.fft.rfft(frames * window, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
    else:
        if bases is None:
            bases = [torch.from_numpy(b).to(y.device) for b in dft_bases(window.cpu().numpy(),
                                                                         n_fft)]
        re, im = frames @ bases[0], frames @ bases[1]
        power = re * re + im * im
    return torch.sqrt(power + 1e-9).transpose(-1, -2)


class MelSpectrogram:
    """Log-mel extractor: waveform ``[L]`` or ``[B, L]`` in [-1, 1] ->
    log10-mel ``[B, n_mels, T]`` with T = 1 + (L + 2 pad - n_fft) // hop, on
    the waveform's device. Differentiable (the HiFi-GAN recipe's mel L1)."""

    def __init__(self, config: MelConfig = DEFAULT_MEL_CONFIG, use_fft: bool = False):
        self.config = config
        self.use_fft = use_fft
        self._np = {"mel": mel_filterbank(config.sample_rate, config.n_fft, config.n_mels,
                                          config.fmin, config.fmax),
                    "window": hann_window(config.win_size)}
        cos_b, sin_b = dft_bases(self._np["window"], config.n_fft)
        self._np.update(cos=cos_b, sin=sin_b)
        self._dev: Dict[tuple, Dict[str, torch.Tensor]] = {}

    def constants(self, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
        """The filterbank, window and DFT bases on ``device`` (made once)."""
        key = (device, dtype)
        if key not in self._dev:
            self._dev[key] = {k: torch.from_numpy(v).to(device, dtype)
                              for k, v in self._np.items()}
        return self._dev[key]

    def __call__(self, y) -> torch.Tensor:
        """fp32 unless ``y`` is a float64 tensor (then float64 throughout)."""
        y = torch.as_tensor(y)
        if y.dtype != torch.float64:
            y = y.float()
        if y.ndim == 1:
            y = y[None]
        cfg = self.config
        c = self.constants(y.device, y.dtype)
        y = reflect_pad(torch.clamp(y, -1.0, 1.0), cfg.pad, cfg.pad)
        mag = stft_magnitude(y, c["window"], cfg.n_fft, cfg.hop_size, self.use_fft,
                             (c["cos"], c["sin"]))
        mel = torch.matmul(c["mel"], mag)  # [M, F] @ [B, F, T]
        return dynamic_range_compression(mel, clip_val=cfg.clip_val)

    def num_frames(self, num_samples: int) -> int:
        cfg = self.config
        return 1 + (num_samples + 2 * cfg.pad - cfg.n_fft) // cfg.hop_size
