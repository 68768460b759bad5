"""CLAP, the contrastive language-audio model, for reranking and zero-shot
use (port of ``versband_tpu/text/clap.py``), eval mode only.

* ``Cnn14`` (``CLAP/audio.py:107-178``): the log-mel front end, ``bn0``
  over the mel axis, six ``ConvBlock``s (two 3x3 convs, each with an
  eval-mode ``BatchNorm2d`` and ReLU, then a 2x2 average pool but after the
  last), the mean over the mel axis, max + mean over time, ``fc1`` with
  ReLU and the sigmoid AudioSet head;
* ``AudioEncoder`` (Cnn14 + ``Projection``), ``TextEncoder`` (the BERT of
  ``text/bert.py`` + ``Projection`` on the CLS token) and ``CLAP`` with its
  ``logit_scale``; ``compute_similarity`` is exp(logit_scale) times the
  cosine matrix, each norm + 1e-8;
* ``CLAPWrapper``: reads the JAX converter's ``.npz`` and classifies audio
  against captions.

Module and parameter names are the reference checkpoint's
(``audio_encoder.base.conv_block1.bn1.running_var``,
``caption_encoder.projection.linear1.weight``, ``logit_scale``, ...), so a
reference ``.pth`` state_dict loads as it is, BatchNorm statistics
included; the JAX package folds each BatchNorm into an affine instead
(``utils/convert.py``'s ``clap`` family maps between the two). The log-mel
is the port's own (``dsp/mel.py``: periodic Hann, Slaney mel filters, the
centre pad by reflection), power re^2 + im^2, ``10 log10(max(mel, 1e-10))``.
The convolutions and products are plain PyTorch: in the JAX package they
run in XLA, not in a Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from versband_tpu_torch.device import DeviceLike, resolve_device
from versband_tpu_torch.dsp.mel import hann_window, mel_filterbank, reflect_pad
from versband_tpu_torch.text.embedders import Projection, _FrozenBertTower

CNN14_DEFAULTS = dict(sample_rate=44100, window_size=1024, hop_size=320, mel_bins=64,
                      fmin=50.0, fmax=14000.0, classes_num=527, out_emb=2048,
                      channels=(64, 128, 256, 512, 1024, 2048))


class ConvBlock(nn.Module):
    """Two 3x3 conv -> eval BatchNorm -> ReLU, then an average pool
    (``audio.py:13-49``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_channels)
        self.bn2 = nn.BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor, pool: Tuple[int, int] = (2, 2)) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return F.avg_pool2d(x, pool) if pool != (1, 1) else x


def clap_logmel(wav: torch.Tensor, sr: int, n_fft: int, hop: int, mel_bins: int, fmin: float,
                fmax: float) -> torch.Tensor:
    """Centre-padded |STFT|^2 -> mel -> 10 log10 power (amin 1e-10):
    ``[B, n]`` -> ``[B, frames, mel_bins]``."""
    x = reflect_pad(wav.float(), n_fft // 2, n_fft // 2)
    window = torch.from_numpy(hann_window(n_fft)).to(x.device)
    frames = x.unfold(-1, n_fft, hop) * window  # [B, T', n_fft]
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, mel_bins, fmin, fmax)).to(x.device)
    return 10.0 * torch.log10(torch.clamp(power @ fb.T, min=1e-10))


class Cnn14(nn.Module):
    """The AudioSet CNN tower (``audio.py:107-178``):
    wav ``[B, n]`` -> ``{"embedding": [B, out_emb], "clipwise_output": [B, classes]}``."""

    def __init__(self, sample_rate: int = 44100, window_size: int = 1024, hop_size: int = 320,
                 mel_bins: int = 64, fmin: float = 50.0, fmax: float = 14000.0,
                 classes_num: int = 527, out_emb: int = 2048,
                 channels: Sequence[int] = CNN14_DEFAULTS["channels"]):
        super().__init__()
        self.front = (sample_rate, window_size, hop_size, mel_bins, fmin, fmax)
        self.n_blocks = len(channels)
        self.bn0 = nn.BatchNorm2d(mel_bins)
        for i, (ci, co) in enumerate(zip((1,) + tuple(channels[:-1]), channels)):
            self.add_module(f"conv_block{i + 1}", ConvBlock(ci, co))
        self.fc1 = nn.Linear(channels[-1], out_emb)
        self.fc_audioset = nn.Linear(out_emb, classes_num)

    def forward(self, wav: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = clap_logmel(wav, *self.front)[:, None]  # [B, 1, T, M]
        x = self.bn0(x.transpose(1, 3)).transpose(1, 3)  # over the mel axis
        for i in range(self.n_blocks):
            pool = (1, 1) if i == self.n_blocks - 1 else (2, 2)
            x = getattr(self, f"conv_block{i + 1}")(x, pool)
        x = x.mean(dim=3)  # over mel -> [B, C, T]
        x = x.amax(dim=2) + x.mean(dim=2)  # over time
        x = F.relu(self.fc1(x))
        return {"embedding": x, "clipwise_output": torch.sigmoid(self.fc_audioset(x))}


class AudioEncoder(nn.Module):
    """Cnn14 + projection (``clap.py:22-40``); the projection's LayerNorm eps
    is flax's 1e-6, as in JAX."""

    def __init__(self, d_out: int = 1024, cnn_kwargs: Optional[dict] = None):
        super().__init__()
        kw = {**CNN14_DEFAULTS, **(cnn_kwargs or {})}
        self.base = Cnn14(**kw)
        self.projection = Projection(kw["out_emb"], d_out, eps=1e-6)

    def forward(self, wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.base(wav)
        return self.projection(out["embedding"]), out["clipwise_output"]


class TextEncoder(nn.Module):
    """The BERT tower + projection of its CLS token (``clap.py:42-52``)."""

    def __init__(self, base: nn.Module, d_out: int):
        super().__init__()
        self.base = base
        self.projection = Projection(base.config["hidden_size"], d_out)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.projection(self.base(input_ids)[:, 0, :])


class CLAP(nn.Module):
    """Audio tower + BERT caption tower + temperature (``clap.py:54-100``).

    The caption tower and its tokenizer come from ``_FrozenBertTower``
    (``text_model``: a BERT directory, else the random fallback geometry
    with ``fallback_config``). The audio tower and the projections start
    from a seeded init; ``load_state_dict`` (reference names) or
    ``load_converted`` (a JAX tree) set them."""

    def __init__(self, d_proj: int = 1024, text_model: str = "bert-base-uncased",
                 sample_rate: int = 44100, duration: float = 5.0,
                 cnn_kwargs: Optional[dict] = None, seed: int = 0, device: DeviceLike = None,
                 **kw):
        super().__init__()
        self.device = resolve_device(device)
        self.sample_rate = sample_rate
        self.duration = duration
        g = torch.Generator().manual_seed(seed)
        self.audio_encoder = AudioEncoder(d_proj, cnn_kwargs)
        with torch.no_grad():
            for name, p in self.audio_encoder.named_parameters():
                if p.ndim > 1:
                    fan_in = p[0].numel()
                    p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * fan_in ** -0.5)
        tower = _FrozenBertTower(text_model, fallback_config=kw.get("fallback_config"),
                                 device="cpu")
        self.tokenize = tower.tokenize
        self.caption_encoder = TextEncoder(tower.model, d_proj)
        self.caption_encoder.projection.init_uniform(g)
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1.0 / 0.07))))
        self.to(self.device).eval().requires_grad_(False)

    def load_converted(self, tree: Dict[str, Any]) -> None:
        """Set the audio tower, the caption projection and ``logit_scale``
        from a converted reference checkpoint (the JAX converter's ``clap``
        family); the BERT tower travels as a directory."""
        from versband_tpu_torch.utils.convert import state_dict_from_jax

        result = self.load_state_dict(state_dict_from_jax(tree, "clap"), strict=False)
        if result.unexpected_keys:
            raise ValueError(f"converted CLAP weights the model lacks: {result.unexpected_keys}")

    def _wav(self, wavs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(wavs) if not torch.is_tensor(wavs) else wavs,
                               dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def get_audio_embeddings(self, wavs) -> torch.Tensor:
        """wavs ``[B, n]`` (an array or a tensor) -> ``[B, d_proj]``."""
        emb, _ = self.audio_encoder(self._wav(wavs))
        return emb

    @torch.no_grad()
    def get_text_embeddings(self, texts: Sequence[str]) -> torch.Tensor:
        ids = torch.from_numpy(np.asarray(self.tokenize(list(texts)), np.int64))
        return self.caption_encoder(ids.to(self.device))

    @torch.no_grad()
    def compute_similarity(self, audio_emb: torch.Tensor, text_emb: torch.Tensor
                           ) -> torch.Tensor:
        """exp(logit_scale) * cos(audio, text) ``[Na, Nt]`` (``CLAPWrapper.py``)."""
        a = audio_emb / (audio_emb.norm(dim=-1, keepdim=True) + 1e-8)
        t = text_emb / (text_emb.norm(dim=-1, keepdim=True) + 1e-8)
        return float(np.exp(float(self.logit_scale))) * a @ t.T


class CLAPWrapper:
    """Zero-shot classification (``CLAPWrapper.py:18-237``): ``model_fp`` is
    the JAX converter's ``.npz``; without one the weights stay random. A
    file that cannot be read raises, where JAX prints and goes on with
    random weights."""

    def __init__(self, model_fp: Optional[str] = None, use_cuda: bool = False, **clap_kwargs):
        self.clap = CLAP(**clap_kwargs)
        if model_fp and model_fp.endswith(".npz"):
            from versband_tpu_torch.utils.checkpoint import load_npz_params

            self.clap.load_converted(load_npz_params(model_fp))

    def classify_audio(self, wav, captions: Sequence[str]) -> np.ndarray:
        a = self.clap.get_audio_embeddings(np.asarray(wav)[None])
        t = self.clap.get_text_embeddings(captions)
        return torch.softmax(self.clap.compute_similarity(a, t), dim=-1)[0].cpu().numpy()
