"""Parallel WaveGAN's own spans and counter (``ParallelWaveGANGenerator.forward``,
through ``versband_tpu_torch/utils/profiling.py``): with spans on, one call
of the wrapper records ``vocoder.pwg.upsample`` and ``vocoder.pwg.wavenet``
once each inside ``vocoder.waveform`` and counts B x T samples, on the fused
and the dense path; with spans off nothing is recorded; the waveform is the
same bit for bit either way."""

import pytest
import torch

from versband_tpu_torch.utils import profiling
from versband_tpu_torch.vocoder.pwg import ParallelWaveGAN

TINY = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16, skip_channels=8,
            aux_channels=8, aux_context_window=2, upsample_scales=[2, 3])


@pytest.fixture(autouse=True)
def clean():
    profiling.spans_off()
    profiling.drain()
    yield
    profiling.spans_off()
    profiling.drain()


def _serve(voc: ParallelWaveGAN, mel: torch.Tensor) -> torch.Tensor:
    voc.generator.manual_seed(11)  # the same noise on every call
    return voc.waveform(mel)


@pytest.mark.parametrize("fused", [True, False])
def test_spans_and_samples_of_one_call(fused):
    voc = ParallelWaveGAN(None, device="cpu", fused_inference=fused, **TINY)
    mel = torch.randn(3, TINY["aux_channels"], 5)
    off = _serve(voc, mel)
    assert profiling.drain() == ([], {})

    profiling.spans_on()
    on = _serve(voc, mel)
    profiling.spans_off()
    spans, counts = profiling.drain()
    assert torch.equal(on, off)
    assert [s.name for s in spans] == ["vocoder.waveform", "vocoder.pwg.upsample",
                                       "vocoder.pwg.wavenet"]
    outer, up, net = spans
    assert up.parent == 0 and net.parent == 0
    assert outer.start_ns <= up.start_ns <= up.end_ns <= net.start_ns <= net.end_ns \
        <= outer.end_ns
    assert counts == {"vocoder.pwg.samples": 3 * 5 * 6}

    assert torch.equal(_serve(voc, mel), off)
    assert profiling.drain() == ([], {})
