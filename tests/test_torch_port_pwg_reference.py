"""The port's Parallel WaveGAN (``versband_tpu_torch/vocoder/pwg.py``) held
to the benchmark's plain reference (``benchmark/reference/pwg.py``) on the
CPU at a tiny width, on seeded random weights: the wrapper's waveform
against the reference fed the same noise and the same padded mel, on the
fused path (K5's plain CPU version) and on the dense path."""

import math

import pytest
import torch

from benchmark.reference import pwg as ref
from versband_tpu_torch.vocoder.pwg import ParallelWaveGAN

TINY = dict(layers=6, stacks=2, residual_channels=8, gate_channels=16, skip_channels=8,
            aux_channels=8, kernel_size=3, aux_context_window=2, upsample_scales=[2, 2])
# float32 on both sides, the same products (the fused layer's plain version
# is the dense layer): equal here, or a few ulps an operation in another
# summation order; products rounded to TF32 read about 6e-4 at this width,
# to bfloat16 about 5e-3, a wrong dilation about 1
TOL = 1e-5


def _wrapper(fused: bool, seed: int = 3) -> ParallelWaveGAN:
    voc = ParallelWaveGAN(None, device="cpu", fused_inference=fused, seed=seed, **TINY)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(voc.model.named_parameters()):
            x = torch.randn(p.shape, generator=g)
            p.copy_(x / math.sqrt(math.prod(p.shape[1:])) if p.ndim >= 2 else 0.1 * x)
    return voc


def _served(voc: ParallelWaveGAN, mel: torch.Tensor):
    """The wrapper's waveform and the inputs its generator was called with."""
    seen = []
    handle = voc.model.register_forward_pre_hook(lambda _m, args: seen.append(args[:2]))
    try:
        wav = voc.waveform(mel)
    finally:
        handle.remove()
    (noise, cpad), = seen
    return wav, noise, cpad


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("fused", [True, False])
def test_waveform_is_the_references(fused):
    voc = _wrapper(fused)
    W = {k: v.detach().clone() for k, v in voc.model.state_dict().items()}
    mel = torch.randn(2, TINY["aux_channels"], 12, generator=torch.Generator().manual_seed(5))
    wav, noise, cpad = _served(voc, mel)
    assert wav.shape == (2, 12 * 4) and noise.shape == (2, 1, 12 * 4)
    P = ref.Precision()
    assert torch.equal(cpad, ref.pad_mel(mel, TINY))
    assert _rel(wav, ref.generator(W, TINY, noise, cpad, P)) < TOL
    assert _rel(wav, ref.vocode(W, TINY, mel, noise, P)) < TOL


def test_a_wrong_dilation_is_seen():
    """The same comparison with the port's layer 2 at half its dilation."""
    voc = _wrapper(True)
    W = {k: v.detach().clone() for k, v in voc.model.state_dict().items()}
    voc.model.conv_layers[2].dilation //= 2
    mel = torch.randn(1, TINY["aux_channels"], 12, generator=torch.Generator().manual_seed(6))
    wav, noise, cpad = _served(voc, mel)
    assert _rel(wav, ref.generator(W, TINY, noise, cpad, ref.Precision())) > 100 * TOL


def test_reference_dilations_and_precisions():
    assert ref.dilations(dict(layers=30, stacks=3)) == [2 ** (i % 10) for i in range(30)]
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -9])
    assert ref.Precision("tf32").q(x).tolist() == [1.0, 1.0 + 2 ** -9]
    assert ref.Precision("bf16").q(x).tolist() == [1.0, 1.0]
    with pytest.raises(ValueError):
        ref.Precision("fp16")
