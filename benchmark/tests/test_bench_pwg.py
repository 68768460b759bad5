"""The Parallel WaveGAN cell's pieces on the CPU: K5's bound and PWG's FLOPs
(``benchmark/lib/wavenet.py``) against hand counts, the new readers on a
summary without their spans, and the ``serve_vocoder`` driver at tiny
widths, sound and with its timed path broken underneath (a layer's
dilation halved; the vocoder in bfloat16), where ``voc_gap`` must fail.
The ``cuda`` case runs the driver at tiny widths on a card."""

import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.drivers import serve_vocoder as sv
from benchmark.lib import cells, compare, wavenet, weights
from benchmark.reference import pwg as ref
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
CELL = "accomp_band_pwg.serve"
PUBLISHED = cells.cell(CELL)["config_data"]["vocoder"]["generator"]
# the published generator but for its widths and depth: the VAE's 80 mel
# channels and the 320-sample hop stay, so a tiny take is still 0.64 s of audio
TINY = dict(layers=6, stacks=2, residual_channels=8, gate_channels=16, skip_channels=8)


def _tiny():
    cell = tiny_cell(CELL)
    cell["config_data"]["vocoder"]["generator"].update(TINY)
    return cell


def _checks(cell, device=CPU):
    return sv.run(cell, SEED, 0.5, False, time.perf_counter(), device)["checks"]


def test_k5_bound_at_the_published_shape():
    ms, by = wavenet.layer_bound_ms(1, 481280, 64, 64, 64, 80)
    assert round(ms, 4) == 0.2513 and by == "operations"
    assert wavenet.request_bound_ms(PUBLISHED, 4, 1504) == pytest.approx(120 * ms)


def test_pwg_flops_of_a_take():
    T, t = 1504, 481280
    hand = 2 * (80 * 80 * 5 * T  # context conv
                + 80 * (9 * 6016 + 9 * 24064 + 9 * 96256 + 11 * t)  # smoothing stencils
                + 64 * t  # first 1x1
                + 30 * (64 * 128 * 3 + 80 * 128 + 64 * 64 + 64 * 64) * t  # residual layers
                + 64 * 64 * t + 64 * t)  # output 1x1s
    assert wavenet.generator_flops(PUBLISHED, 1, T) == hand
    cfg = dict(PUBLISHED, **TINY, aux_channels=8, upsample_scales=[2, 3])
    voc = sv.build_vocoder({"family": "pwg", "dtype": "float32", "generator": cfg}, CPU)
    W = weights.make(weights.spec_of(voc.model), 1, "voc", CPU)
    mel, noise = torch.randn(2, 8, 7), torch.randn(2, 1, 42)
    with FlopCounterMode(display=False) as fc:
        ref.vocode(W, cfg, mel, noise, ref.Precision())
    assert fc.get_total_flops() == wavenet.generator_flops(cfg, 2, 7)


def test_the_cell_serves_build_vocoders_generator():
    from versband_tpu_torch.cli.generate import build_vocoder

    config = cells.cell(CELL)["config_data"]["vocoder"]
    ours = sv.build_vocoder(config, CPU)
    cli = build_vocoder(config["family"], device=CPU)
    assert weights.spec_of(ours.model) == weights.spec_of(cli.model)
    assert ours.model.fused_inference and ours.hop == 320
    with pytest.raises(ValueError, match="no reference"):
        sv.build_vocoder(dict(config, family="bigvgan"), CPU)


@pytest.mark.parametrize("name", ["vocode_busy_ms.pwg", "pwg_upsample_busy_ms.pwg",
                                  "k5_roofline.pwg"])
def test_readers_read_nothing_without_their_spans(name):
    read = cells.metric_reader(name)
    bare = {"spans": {"vocoder.hifigan": {"busy_s": 1.0, "host_s": 1.0, "count": 1}},
            "ops": {}, "requests": 2, "window_s": 1.0, "busy_s": 1.0, "k5_bound_ms": 30.0}
    assert read(bare) is None
    assert read({**bare, "program": {"vocoder.waveform": {"busy_s": 1.0}}}) is None
    span = {"busy_s": 0.5, "host_s": 0.6, "count": 8}
    full = {**bare, "spans": {"vocoder.pwg": span},
            "program": {"vocoder.pwg.upsample": span, "vocoder.pwg.wavenet": span}}
    want = {"vocode_busy_ms.pwg": 250.0, "pwg_upsample_busy_ms.pwg": 250.0,
            "k5_roofline.pwg": 12.0}[name]
    assert read(full) == pytest.approx(want)


def test_sound_run_is_correct():
    cell = _tiny()
    ok, lines = compare.judge(_checks(cell), cell["limits"])
    assert ok, lines


def _dilation_halved(monkeypatch):
    """Layer 2 (dilation 4) of the served generator at dilation 2."""
    from versband_tpu_torch.vocoder.pwg import ParallelWaveGAN

    init = ParallelWaveGAN.__init__

    def halved(self, *args, **kw):
        init(self, *args, **kw)
        self.model.conv_layers[2].dilation //= 2

    monkeypatch.setattr(ParallelWaveGAN, "__init__", halved)


def _vocoder_in_bf16(monkeypatch):
    """The generator served in bfloat16 (K5's bf16 path) where the
    configuration says float32."""
    build = sv.build_vocoder
    monkeypatch.setattr(sv, "build_vocoder",
                        lambda vocoder, device: build(dict(vocoder, dtype="bfloat16"), device))


@pytest.mark.parametrize("fault", [_dilation_halved, _vocoder_in_bf16])
def test_a_broken_vocoder_fails_voc_gap(monkeypatch, fault):
    fault(monkeypatch)
    cell = _tiny()
    checks = _checks(cell)
    assert checks["voc_gap"] > cell["limits"]["voc_gap"], checks


@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_a_lower_precision_vocoder_fails_voc_gap(precision):
    """The reference's own PWG with its products in single-pass TF32 (the
    float32 vocoder's control) or bfloat16, on the same inputs."""
    cell = _tiny()
    config = cell["config_data"]
    gen = config["vocoder"]["generator"]
    voc = sv.build_vocoder(config["vocoder"], CPU)
    W = {"voc": sv.vocoder_weights(weights.spec_of(voc.model), SEED, CPU)}
    g = torch.Generator().manual_seed(SEED)
    mel = torch.randn(2, 80, 48, generator=g)
    noise = torch.randn(2, 1, 48 * 320, generator=g)
    got = ref.vocode(W["voc"], gen, mel, noise, ref.Precision(precision))
    gap = sv.vocoder_gap(config, W, got, noise, ref.pad_mel(mel, gen), CPU)
    assert gap > cell["limits"]["voc_gap"], gap


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tiny_cell_runs_on_the_card(card):
    from versband_tpu_torch.device import resolve_device

    resolve_device(card)
    cell = _tiny()
    ok, lines = compare.judge(_checks(cell, card), cell["limits"])
    assert ok, lines
