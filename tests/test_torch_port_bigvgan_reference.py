"""The port's BigVGAN (``versband_tpu_torch/vocoder/bigvgan.py``) held to the
benchmark's plain reference (``benchmark/reference/bigvgan.py``) on the CPU,
on seeded random weights in float32, at the published geometry cut to a
small width: six stages at rates (5, 4, 2, 2, 2, 2) with kernels
(9, 8, 4, 4, 4, 4), 64 initial channels (32 down to 1), AMPBlock1 with
kernels (3, 7, 11) at dilations (1, 3, 5), Snake and SnakeBeta with
``logscale`` on and off, the fused path (K4's plain CPU version) and the
unfused modules. With spans on, one call of the wrapper records the
generator's spans and counters as ``benchmark/lib/bigvgan.py`` predicts."""

import math

import pytest
import torch

from benchmark.lib import bigvgan as counts
from benchmark.reference import bigvgan as ref
from versband_tpu_torch.utils import profiling
from versband_tpu_torch.vocoder.bigvgan import BigVGANGenerator, VocoderBigVGAN

GEOMETRY = dict(num_mels=80, upsample_initial_channel=64, upsample_rates=[5, 4, 2, 2, 2, 2],
                upsample_kernel_sizes=[9, 8, 4, 4, 4, 4], resblock="1",
                resblock_kernel_sizes=[3, 7, 11], resblock_dilation_sizes=[[1, 3, 5]] * 3)
FRAMES = 6
# float32 on both sides with the same convolutions; the resampling taps come
# from numpy's kaiser window in the port and torch's in the reference, which
# agree to an ulp of float32, and the unfused activation sums its taps in the
# same order: equal here, or a few ulps an operation. Convolutions rounded to
# TF32 read about 1.6e-2 at this width (checked below), to bfloat16 0.12, a
# wrong dilation 0.8. The chain of 109 activations amplifies a rounding
# difference about a hundredfold: the same mels convolved in batches of
# another size (another CPU algorithm) read 2e-5, so both sides run the same
# batch.
TOL = 1e-5


def _cfg(variant: str, logscale: bool) -> dict:
    return dict(GEOMETRY, activation=variant, snake_logscale=logscale)


def _weights(model: torch.nn.Module, logscale: bool, seed: int = 3) -> dict:
    """Seeded weights: convolutions N(0, 1/fan_in) (the waveform follows the
    mel), biases N(0, 0.01), Snake parameters around 0 (log) or 1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            x = torch.randn(p.shape, generator=g)
            if p.ndim >= 2:
                p.copy_(x / math.sqrt(math.prod(p.shape[1:])))
            elif name.endswith((".alpha", ".beta")):
                p.copy_(0.3 * x if logscale else 1.0 + 0.3 * x.clamp(-2, 2))
            else:
                p.copy_(0.1 * x)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _mel(seed: int = 5, batch: int = 2) -> torch.Tensor:
    return torch.randn(batch, 80, FRAMES, generator=torch.Generator().manual_seed(seed))


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("logscale", [True, False], ids=["log", "linear"])
@pytest.mark.parametrize("variant", ["snakebeta", "snake"])
def test_generator_is_the_references(variant, logscale, fused):
    cfg = _cfg(variant, logscale)
    model = BigVGANGenerator(**cfg, use_fused=fused).eval()
    W = _weights(model, logscale)
    assert ("resblocks.0.activations.0.act.beta" in W) == (variant == "snakebeta")
    mel = _mel()
    with torch.no_grad():
        got = model(mel)
    want = ref.generator(W, cfg, mel, ref.Precision())
    assert got.shape == want.shape == (2, FRAMES * 320)
    assert _rel(got, want) < TOL


def test_lower_precision_and_a_wrong_dilation_are_seen():
    """The tolerance is tight enough: the reference's convolutions in
    single-pass TF32, and the port with one AMP convolution at another
    dilation, both fail it."""
    cfg = _cfg("snakebeta", True)
    model = BigVGANGenerator(**cfg).eval()
    W = _weights(model, True)
    mel = _mel(7, 1)
    want = ref.generator(W, cfg, mel, ref.Precision())
    assert _rel(ref.generator(W, cfg, mel, ref.Precision("tf32")), want) > 10 * TOL
    conv = model.resblocks[4].convs1[1]  # stage 2, kernel 7, dilation 3
    conv.dilation, conv.padding = (1,), (3,)
    with torch.no_grad():
        assert _rel(model(mel), want) > 100 * TOL


def test_reference_taps_are_the_published_filter():
    from versband_tpu_torch.ops.fused_act1d import kaiser_sinc_filter1d

    taps = ref.kaiser_sinc_taps(0.25, 0.3, ref.TAPS)
    assert taps.shape == (12,) and abs(float(taps.sum()) - 1.0) < 1e-6
    assert torch.allclose(taps, torch.from_numpy(kaiser_sinc_filter1d(0.25, 0.3, 12)),
                          rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="AMPBlock1"):
        ref.generator({}, dict(GEOMETRY, resblock="2"), _mel(), ref.Precision())


@pytest.fixture
def spans():
    profiling.spans_off()
    profiling.drain()
    yield
    profiling.spans_off()
    profiling.drain()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_spans_and_counters_of_one_call(spans, fused):
    cfg = _cfg("snakebeta", True)
    voc = VocoderBigVGAN(None, device="cpu", seed=4, **cfg)
    for m in voc.model.modules():
        if hasattr(m, "use_fused"):
            m.use_fused = fused
    mel = _mel(9, 3)
    off = voc.waveform(mel)
    assert profiling.drain() == ([], {})

    profiling.spans_on()
    on = voc.waveform(mel)
    profiling.spans_off()
    got, counters = profiling.drain()
    assert torch.equal(on, off)
    names = [s.name for s in got]
    stages, acts = len(cfg["upsample_rates"]), 6 * len(cfg["resblock_kernel_sizes"])
    assert names[0] == "vocoder.waveform"
    assert names.count("vocoder.bigvgan.upsample") == names.count("vocoder.bigvgan.amp") == stages
    assert names.count("vocoder.bigvgan.act") == stages * acts + 1 == 109
    assert counters == {"vocoder.bigvgan.samples": 3 * FRAMES * 320,
                        "vocoder.bigvgan.act_samples": counts.activation_samples(cfg, 3, FRAMES)}
    index = {i: s for i, s in enumerate(got)}
    for s in got[1:]:
        parent = index[s.parent].name
        if s.name == "vocoder.bigvgan.act":
            assert parent in ("vocoder.bigvgan.amp", "vocoder.waveform")
        else:
            assert parent == "vocoder.waveform"
    assert [index[s.parent].name for s in got if s.name == "vocoder.bigvgan.act"].count(
        "vocoder.waveform") == 1  # the activation before conv_post

    assert torch.equal(voc.waveform(mel), off)
    assert profiling.drain() == ([], {})
