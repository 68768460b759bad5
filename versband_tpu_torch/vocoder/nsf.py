"""HiFi-GAN NSF, the f0-driven neural source-filter vocoder (port of
``versband_tpu/vocoder/nsf.py``; reference ``vocoder/hifigan/modules/hifigan_nsf.py``
and the wrapper ``vocoder/hifigan/hifigan_nsf.py``).

For each f0 sample, harmonics 1..H+1 are phase-continuous sines (the
cumulative sum of the instantaneous frequency), kept where voiced, plus
noise; a tanh-ed linear layer (``m_source.l_linear``) mixes them into one
excitation, which ``noise_convs.{i}`` inject into every upsampling stage of
the HiFi-GAN stack.

The draws (initial phases, noise) come from an explicit ``torch.Generator``,
or are handed in as ``init_phase`` / ``noise`` (torch and JAX streams never
agree, so the parity tests inject JAX's draws). The phase's running sum is
taken in float64: over a 20 s clip it reaches ~1e5 cycles, where an fp32
sum would be off by a hundredth of a cycle; JAX sums in fp32, which agrees at
the tests' lengths.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from versband_tpu_torch.device import DeviceLike, resolve_device
from versband_tpu_torch.dsp.mel import mel_filterbank
from versband_tpu_torch.utils.checkpoint import get_last_checkpoint
from versband_tpu_torch.utils.profiling import annotate
from versband_tpu_torch.vocoder.hifigan import HifiGanGenerator, load_generator_state_dict


def sine_gen(f0: torch.Tensor, sampling_rate: int, harmonic_num: int = 8,
             sine_amp: float = 0.1, noise_std: float = 0.003, voiced_threshold: float = 0.0,
             generator: Optional[torch.Generator] = None,
             init_phase: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f0 ``[B, T, 1]`` at the sample rate -> (sines ``[B, T, H+1]``, uv ``[B, T, 1]``).

    ``init_phase`` ``[B, 1, H+1]`` (uniform in [0, 1); the fundamental's is
    set to 0) and ``noise`` ``[B, T, H+1]`` (standard normal) are drawn from
    ``generator`` unless given."""
    B, T, _ = f0.shape
    H = harmonic_num + 1
    if init_phase is None:
        init_phase = torch.rand((B, 1, H), generator=generator, device=f0.device)
    if noise is None:
        noise = torch.randn((B, T, H), generator=generator, device=f0.device)
    init_phase = init_phase.to(f0.device, torch.float32).clone()
    init_phase[:, :, 0] = 0.0
    harmonics = torch.arange(1, H + 1, device=f0.device, dtype=torch.float64)
    # harmonic k's phase in cycles is k x the fundamental's running sum: one
    # scan along a contiguous [B, T] (a scan along T of [B, T, H] runs 30x
    # slower on the card)
    cum = torch.cumsum(f0[..., 0].double() / sampling_rate, dim=1)  # [B, T]
    cycles = cum[..., None] * harmonics + init_phase.double()
    sines = torch.sin(2 * np.pi * torch.remainder(cycles, 1.0).float())
    uv = (f0 > voiced_threshold).float()
    noise_amp = uv * noise_std + (1.0 - uv) * sine_amp / 3.0
    return sine_amp * sines * uv + noise_amp * noise.to(f0.device, torch.float32), uv


class SourceModuleHnNSF(nn.Module):
    """Harmonic-plus-noise source: ``tanh(l_linear(sines))`` ``[B, T, 1]``."""

    def __init__(self, sampling_rate: int, harmonic_num: int = 8, sine_amp: float = 0.1,
                 noise_std: float = 0.003):
        super().__init__()
        self.sampling_rate, self.harmonic_num = sampling_rate, harmonic_num
        self.sine_amp, self.noise_std = sine_amp, noise_std
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0: torch.Tensor, generator: Optional[torch.Generator] = None,
                init_phase: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        sines, _ = sine_gen(f0, self.sampling_rate, self.harmonic_num, self.sine_amp,
                            self.noise_std, generator=generator, init_phase=init_phase,
                            noise=noise)
        return torch.tanh(self.l_linear(sines.to(self.l_linear.weight.dtype)))


class NSFHifiGanGenerator(HifiGanGenerator):
    """(mel ``[B, 80, T]``, f0 ``[B, T]``) -> wav ``[B, T*hop]``
    (``modules/hifigan_nsf.py:104-173``). Without f0 the source is skipped
    and the HiFi-GAN stack runs alone. ``noise_convs`` never carry weight
    norm (as in JAX)."""

    def __init__(self, in_channels: int = 80, audio_sample_rate: int = 24000,
                 upsample_initial_channel: int = 512,
                 upsample_rates: Sequence[int] = (5, 4, 4, 4),
                 upsample_kernel_sizes: Sequence[int] = (9, 8, 8, 8), resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 harmonic_num: int = 8, source_noise_std: float = 0.003,
                 use_weight_norm: bool = False):
        super().__init__(in_channels, upsample_initial_channel, upsample_rates,
                         upsample_kernel_sizes, resblock, resblock_kernel_sizes,
                         resblock_dilation_sizes, use_weight_norm)
        self.hop = int(np.prod(upsample_rates))
        self.m_source = SourceModuleHnNSF(audio_sample_rate, harmonic_num,
                                          noise_std=source_noise_std)
        convs = []
        for i in range(len(upsample_rates)):
            ch = upsample_initial_channel // 2 ** (i + 1)
            if i + 1 < len(upsample_rates):
                s = int(np.prod(upsample_rates[i + 1:]))
                convs.append(nn.Conv1d(1, ch, 2 * s, s, padding=s // 2))
            else:
                convs.append(nn.Conv1d(1, ch, 1))
        self.noise_convs = nn.ModuleList(convs)

    def forward(self, mel: torch.Tensor, f0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                init_phase: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        har = None
        if f0 is not None:
            f0_up = torch.repeat_interleave(f0[:, :, None], self.hop, dim=1)  # nearest
            har = self.m_source(f0_up, generator, init_phase, noise).transpose(1, 2)
        x = self.conv_pre(mel.to(self.conv_pre.bias.dtype))
        for i in range(len(self.ups)):
            src = None if har is None else self.noise_convs[i](har)
            x = self.upsample_stage(i, x, src)
        return torch.tanh(self.conv_post(F.leaky_relu(x, 0.01)))[:, 0]


def stft_denoise(wav: np.ndarray, v: float = 0.1, n_fft: int = 1024,
                 hop: int = 256) -> np.ndarray:
    """Spectral-magnitude floor denoise (``hifigan_nsf.py:13-21``)."""
    from scipy.signal import istft, stft

    _, _, spec = stft(wav, nperseg=n_fft, noverlap=n_fft - hop, padded=True)
    mag = np.clip(np.abs(spec) - v / n_fft, 0.0, None)
    _, out = istft(mag * np.exp(1j * np.angle(spec)), nperseg=n_fft, noverlap=n_fft - hop)
    return out[: len(wav)].astype(np.float32)


def estimate_f0_from_mel(mel: np.ndarray, sr: int = 24000, n_fft: int = 1280,
                         fmin: float = 0.0, fmax: float = 8000.0) -> np.ndarray:
    """Coarse f0 ``[T]`` of a log-mel ``[M, T]``: pseudo-invert the filterbank
    and take the strongest bin in 60-1000 Hz per frame, 0 where the band's
    energy is under 1e-3 of its largest (``hifigan_nsf.py:60-88``'s piptrack
    approach without librosa)."""
    fb = mel_filterbank(sr, n_fft, mel.shape[0], fmin, fmax)
    lin = np.clip(np.linalg.pinv(fb) @ (10.0 ** mel), 0.0, None)
    freqs = np.linspace(0, sr / 2, lin.shape[0])
    band = (freqs >= 60.0) & (freqs <= 1000.0)
    f0 = freqs[band][np.argmax(lin[band], axis=0)]
    energy = lin[band].max(axis=0)
    f0[energy < energy.max() * 1e-3] = 0.0
    return f0.astype(np.float32)


_CONFIG_KEYS = ("audio_sample_rate", "upsample_initial_channel", "upsample_rates",
                "upsample_kernel_sizes", "resblock", "resblock_kernel_sizes",
                "resblock_dilation_sizes")


class HifiGAN_NSF:
    """Runtime wrapper (``hifigan_nsf.py:44-95``): ``HifiGAN_NSF(ckpt_dir)(mel)``.

    ``vocoder_ckpt`` is a directory with an optional ``config.yaml`` (read by
    the port's YAML reader) and ``model_ckpt_steps_<n>.*`` files, the newest
    step loaded: a JAX ``.npz`` (the ``nsf`` family of ``utils/convert.py``)
    or a reference ``.ckpt`` (torch weight norm folded). Without one the
    generator keeps a random init made from ``seed``. The f0 of a mel is
    estimated from it when not given; the draws come from a generator on the
    wrapper's device seeded from ``seed``. ``use_nsf=False`` runs the
    HiFi-GAN stack without the source."""

    def __init__(self, vocoder_ckpt: Optional[str] = None, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32, use_nsf: bool = True, seed: int = 0,
                 **config_overrides):
        from versband_tpu_torch.utils.config import load_config

        self.device = resolve_device(device)
        self.use_nsf = use_nsf
        cfg = {}
        if vocoder_ckpt and os.path.exists(os.path.join(vocoder_ckpt, "config.yaml")):
            cfg = dict(load_config(os.path.join(vocoder_ckpt, "config.yaml")))
        cfg.update(config_overrides)
        kw = {k: cfg[k] for k in _CONFIG_KEYS if k in cfg}
        self.sr = kw.get("audio_sample_rate", 24000)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = NSFHifiGanGenerator(**kw)
        path = get_last_checkpoint(vocoder_ckpt)[0] if vocoder_ckpt else None
        if path is not None and path.endswith(".npz"):
            from versband_tpu_torch.utils.checkpoint import load_npz_params
            from versband_tpu_torch.utils.convert import state_dict_from_jax

            self.model.load_state_dict(state_dict_from_jax(load_npz_params(path), "nsf"))
        elif path is not None:
            self.model.load_state_dict(load_generator_state_dict(path))
        self.model.to(device=self.device, dtype=dtype).eval()
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def waveform(self, mel: torch.Tensor, f0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel ``[B, 80, T]`` on the wrapper's device -> ``[B, T*hop]`` there.
        Without ``f0`` (and with ``use_nsf``) it is estimated from each mel
        on the host."""
        with annotate("vocoder.waveform"):
            if f0 is None and self.use_nsf:
                f0 = torch.from_numpy(np.stack([estimate_f0_from_mel(m, self.sr)
                                                for m in mel.float().cpu().numpy()]))
            if f0 is not None:
                f0 = torch.as_tensor(f0, dtype=torch.float32).reshape(mel.shape[0], -1)
                f0 = f0.to(self.device)
            return self.model(mel.to(self.dtype), f0, generator=self.generator)

    def spec2wav(self, mel, f0=None, denoise_v: float = 0.0) -> np.ndarray:
        mel = torch.as_tensor(np.asarray(mel) if not torch.is_tensor(mel) else mel)
        if mel.ndim == 2:
            mel = mel[None]
        wav = self.waveform(mel.to(self.device), f0).float().cpu().numpy().reshape(-1)
        return stft_denoise(wav, denoise_v) if denoise_v > 0 else wav

    def vocode(self, mel) -> np.ndarray:
        if np.ndim(mel) != 2:
            raise ValueError("vocode takes one mel [n_mels, T]")
        return self.spec2wav(mel)

    def __call__(self, mel) -> np.ndarray:
        return self.spec2wav(mel)
