"""Waveform losses (port of ``versband_tpu/vocoder/losses.py``): the
multi-resolution STFT loss of ParallelWaveGAN
(``parallel_wavegan/losses/stft_loss.py:12-153``), spectral convergence plus
log-magnitude L1 at three resolutions."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from versband_tpu_torch.dsp.mel import reflect_pad


def padded_hann(win: int, n_fft: int, device=None) -> torch.Tensor:
    """Periodic Hann of ``win`` samples (``np.hanning(win + 1)[:-1]``),
    zero-padded to ``n_fft`` and centred."""
    w = np.hanning(win + 1)[:-1].astype(np.float32)
    if win < n_fft:
        lpad = (n_fft - win) // 2
        w = np.pad(w, (lpad, n_fft - win - lpad))
    return torch.from_numpy(w).to(device)


def stft_magnitude(x: torch.Tensor, fft_size: int, hop: int, win: int) -> torch.Tensor:
    """|STFT| of ``[B, T]`` -> ``[B, frames, fft_size // 2 + 1]``: reflect pad
    of ``fft_size // 2`` (``center=True``), Hann window, ``sqrt(clamp(power,
    1e-7))``."""
    pad = fft_size // 2
    x = reflect_pad(x, pad, pad)
    frames = x.unfold(-1, fft_size, hop)
    spec = torch.fft.rfft(frames * padded_hann(win, fft_size, x.device), n=fft_size, dim=-1)
    return torch.sqrt(torch.clamp(spec.real ** 2 + spec.imag ** 2, min=1e-7))


def spectral_convergence_loss(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    """``||y - x||_F / ||y||_F`` (``stft_loss.py:34-52``)."""
    return torch.linalg.vector_norm(y_mag - x_mag) / (torch.linalg.vector_norm(y_mag) + 1e-12)


def log_stft_magnitude_loss(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    """L1 between log magnitudes (``stft_loss.py:55-73``)."""
    return torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))


def stft_loss(x: torch.Tensor, y: torch.Tensor, fft_size: int = 1024, hop: int = 120,
              win: int = 600) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spectral convergence, log magnitude) of predicted x against target y."""
    x_mag = stft_magnitude(x, fft_size, hop, win)
    y_mag = stft_magnitude(y, fft_size, hop, win)
    return spectral_convergence_loss(x_mag, y_mag), log_stft_magnitude_loss(x_mag, y_mag)


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor,
                               fft_sizes: Sequence[int] = (1024, 2048, 512),
                               hop_sizes: Sequence[int] = (120, 240, 50),
                               win_lengths: Sequence[int] = (600, 1200, 240)
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sc, mag) averaged over the resolutions (``stft_loss.py:109-153``)."""
    sc_total, mag_total = 0.0, 0.0
    for fs, hs, wl in zip(fft_sizes, hop_sizes, win_lengths):
        sc, mag = stft_loss(x, y, fs, hs, wl)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(fft_sizes)
    return sc_total / n, mag_total / n
