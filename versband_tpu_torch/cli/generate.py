"""Inference CLI pieces (port of ``versband_tpu/cli/generate.py``).

Only :func:`build_vocoder` is ported so far; the rest of the CLI (argument
parsing, the T5 caption tower, manifests, writing WAVs) is ROADMAP item 7.
"""

from __future__ import annotations

from typing import Optional

import torch

from versband_tpu_torch.device import DeviceLike


def build_vocoder(name: str, ckpt: Optional[str] = None, device: DeviceLike = None,
                  dtype: torch.dtype = torch.float32):
    """The runtime wrapper of vocoder family ``name`` (``--vocoder``), on
    ``device`` (``None``: the card) in ``dtype``. Every wrapper serves
    ``wrapper(mel_2d) -> np.ndarray`` and ``wrapper.waveform(mel) ->`` a
    device tensor. ``nsf`` is not ported yet (ROADMAP item 11)."""
    if name == "hifigan":
        from versband_tpu_torch.vocoder.hifigan import HifiGAN
        return HifiGAN(ckpt, device=device, dtype=dtype)
    if name == "bigvgan":
        from versband_tpu_torch.vocoder.bigvgan import VocoderBigVGAN
        return VocoderBigVGAN(ckpt, device=device, dtype=dtype)
    if name == "pwg":
        from versband_tpu_torch.vocoder.pwg import ParallelWaveGAN
        return ParallelWaveGAN(ckpt, device=device, dtype=dtype)
    if name == "nsf":
        raise NotImplementedError("the nsf vocoder is not ported yet (ROADMAP item 11)")
    raise ValueError(f"unknown vocoder family: {name}")
