"""The BigVGAN cell's pieces on the CPU: BigVGAN's FLOPs and its activations'
samples and bound (``benchmark/lib/bigvgan.py``) against hand counts and
against the plain reference's own operations, the new readers on summaries
with and without their spans, the weight rules, and the ``serve_bigvgan``
driver at tiny widths, sound and with its timed path broken underneath (a
dilation changed; the vocoder in bfloat16), where ``voc_gap`` must fail.
The ``cuda`` case runs the driver at tiny widths on a card."""

import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.drivers import serve_bigvgan as sb
from benchmark.lib import bigvgan, cells, compare, weights
from benchmark.reference import bigvgan as ref
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
CELL = "accomp_band_bigvgan.serve"
PUBLISHED = cells.cell(CELL)["config_data"]["vocoder"]["generator"]
# the published geometry but for its widths: six stages at the 320-sample
# hop, so a tiny take is still 0.64 s of audio; 64 channels halve to 1
TINY = dict(upsample_initial_channel=64)


def _tiny():
    cell = tiny_cell(CELL)
    cell["config_data"]["vocoder"]["generator"].update(TINY)
    return cell


def _checks(cell, device=CPU):
    return sb.run(cell, SEED, 0.5, False, time.perf_counter(), device)["checks"]


def test_bigvgan_flops_and_activations_of_a_take():
    T = 1504
    chans = [1536, 768, 384, 192, 96, 48, 24]
    lengths = [T, 5 * T, 20 * T, 40 * T, 80 * T, 160 * T, 320 * T]
    kernels = [9, 8, 4, 4, 4, 4]
    hand = 80 * 1536 * 7 * T  # conv_pre
    for i in range(6):
        hand += chans[i] * chans[i + 1] * kernels[i] * lengths[i]  # upsampler, per input
        hand += 3 * 2 * (3 + 7 + 11) * chans[i + 1] ** 2 * lengths[i + 1]  # AMP convs
    hand += 24 * 7 * lengths[-1]  # conv_post
    assert bigvgan.generator_flops(PUBLISHED, 1, T) == 2 * hand
    assert round(2 * hand / 1e12, 4) == 3.3868
    acts = sum(18 * chans[i + 1] * lengths[i + 1] for i in range(6)) + 24 * lengths[-1]
    assert bigvgan.activation_samples(PUBLISHED, 1, T) == acts == 1_155_072_000
    assert bigvgan.activation_samples(PUBLISHED, 4, T) == 4 * acts
    ms, by = bigvgan.act_bound_ms(acts)
    assert by == "bytes" and ms == pytest.approx(acts * 8 / 3.35e12 * 1e3)
    assert round(ms, 4) == 2.7584
    assert bigvgan.act_bound_ms(acts, "bfloat16")[0] == pytest.approx(ms / 2)


def test_counts_match_the_references_own_operations(monkeypatch):
    """At tiny widths: FLOPs as torch counts the reference's convolutions
    (the activations made the identity, their taps being elementwise work),
    and activation samples as the reference's activations see them."""
    cfg = dict(PUBLISHED, **TINY, upsample_rates=[5, 2], upsample_kernel_sizes=[9, 4])
    voc = sb.build_vocoder({"family": "bigvgan", "dtype": "float32", "generator": cfg}, CPU)
    W = sb.vocoder_weights(weights.spec_of(voc.model), 1, CPU, "fan_in")
    mel = torch.randn(2, 80, 7)
    seen = []

    def identity(x, *_):
        seen.append(x.numel())
        return x

    monkeypatch.setattr(ref, "activation", identity)
    with FlopCounterMode(display=False) as fc:
        ref.generator(W, cfg, mel, ref.Precision())
    assert fc.get_total_flops() == bigvgan.generator_flops(cfg, 2, 7)
    assert sum(seen) == bigvgan.activation_samples(cfg, 2, 7) and len(seen) == 2 * 18 + 1


def test_the_cell_serves_build_vocoders_generator():
    from versband_tpu_torch.cli.generate import build_vocoder
    from versband_tpu_torch.vocoder.bigvgan import BigVGANGenerator

    config = _tiny()["config_data"]["vocoder"]
    ours = sb.build_vocoder(config, CPU)
    cli = build_vocoder("bigvgan", device=CPU, **config["generator"])
    assert weights.spec_of(ours.model) == weights.spec_of(cli.model)
    assert ours.model.use_fused and len(ours.model.ups) == 6
    with torch.device("meta"):
        full = BigVGANGenerator(**PUBLISHED)
    assert sum(p.numel() for p in full.parameters()) == 113_379_121
    assert [up[0].out_channels for up in full.ups] == [768, 384, 192, 96, 48, 24]
    with pytest.raises(ValueError, match="bigvgan family"):
        sb.build_vocoder(dict(config, family="pwg"), CPU)


def test_weight_rules():
    spec = weights.spec_of(sb.build_vocoder(_tiny()["config_data"]["vocoder"], CPU).model)
    fan = sb.vocoder_weights(spec, SEED, CPU, "fan_in")
    pub = sb.vocoder_weights(spec, SEED, CPU, "published")
    made = weights.make(spec, SEED, "voc", CPU)
    for name, w in fan.items():
        if name.endswith((".alpha", ".beta")):
            assert not w.any() and not pub[name].any()
        elif w.ndim >= 2:
            assert torch.equal(w, made[name])
        else:
            assert not w.any() and pub[name].any()
    big = pub["resblocks.0.convs1.0.weight"]
    assert big.std().item() == pytest.approx(0.01, rel=0.05)
    with pytest.raises(ValueError, match="unknown vocoder init"):
        sb.vocoder_weights(spec, SEED, CPU, "xavier")


@pytest.mark.parametrize("name", ["vocode_busy_ms.bigvgan", "amp_busy_ms.bigvgan",
                                  "k4_roofline.bigvgan"])
def test_readers_read_nothing_without_their_spans(name):
    read = cells.metric_reader(name)
    bare = {"spans": {"vocoder.pwg": {"busy_s": 1.0, "host_s": 1.0, "count": 1}},
            "ops": {}, "requests": 2, "window_s": 1.0, "busy_s": 1.0}
    assert read(bare) is None
    assert read({**bare, "program": {"vocoder.waveform": {"busy_s": 1.0}}}) is None
    span = {"busy_s": 0.5, "host_s": 0.6, "count": 8}
    full = {**bare, "spans": {"vocoder.bigvgan": span}, "k4_bound_ms": 30.0,
            "program": {"vocoder.bigvgan.amp": span, "vocoder.bigvgan.act": span}}
    want = {"vocode_busy_ms.bigvgan": 250.0, "amp_busy_ms.bigvgan": 250.0,
            "k4_roofline.bigvgan": 12.0}[name]
    assert read(full) == pytest.approx(want)


def test_k4_roofline_on_a_synthetic_trace():
    """The reader's share from a request's activation samples: 3 requests of
    4 published takes whose activations took 2.5x their bound on the card."""
    read = cells.metric_reader("k4_roofline.bigvgan")
    samples = 3 * bigvgan.activation_samples(PUBLISHED, 4, 1504)
    bound_ms, _ = bigvgan.act_bound_ms(samples)
    t = {"spans": {}, "ops": {}, "requests": 3, "window_s": 2.0, "busy_s": 1.5,
         "k4_bound_ms": bound_ms / 3, "counters": {"vocoder.bigvgan.act_samples": samples},
         "program": {"vocoder.bigvgan.act": {"busy_s": 2.5 * bound_ms / 1e3, "host_s": 0.1,
                                             "count": 3 * 4 * 109}}}
    assert read(t) == pytest.approx(40.0)
    assert cells.metric_reader("mfu.bigvgan")(dict(t, flops=1e12, peak_flops=1e12)) == \
        pytest.approx(50.0)


def test_sound_run_is_correct():
    cell = _tiny()
    ok, lines = compare.judge(_checks(cell), cell["limits"])
    assert ok, lines


def _dilation_changed(monkeypatch):
    """Stage 2's kernel-7 AMP convolution at dilation 1 where it has 3."""
    from versband_tpu_torch.vocoder.bigvgan import VocoderBigVGAN

    init = VocoderBigVGAN.__init__

    def changed(self, *args, **kw):
        init(self, *args, **kw)
        conv = self.model.resblocks[4].convs1[1]
        conv.dilation, conv.padding = (1,), (3,)

    monkeypatch.setattr(VocoderBigVGAN, "__init__", changed)


def _vocoder_in_bf16(monkeypatch):
    """The generator served in bfloat16 where the configuration says
    float32."""
    build = sb.build_vocoder
    monkeypatch.setattr(sb, "build_vocoder",
                        lambda vocoder, device: build(dict(vocoder, dtype="bfloat16"), device))


@pytest.mark.parametrize("fault", [_dilation_changed, _vocoder_in_bf16])
def test_a_broken_vocoder_fails_voc_gap(monkeypatch, fault):
    fault(monkeypatch)
    cell = _tiny()
    checks = _checks(cell)
    assert checks["voc_gap"] > cell["limits"]["voc_gap"], checks


@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_a_lower_precision_vocoder_fails_voc_gap(precision):
    """The reference's own BigVGAN with its convolutions in single-pass TF32
    (the float32 vocoder's control) or bfloat16, on the same mels."""
    cell = _tiny()
    config = cell["config_data"]
    voc = sb.build_vocoder(config["vocoder"], CPU)
    W = {"voc": sb.vocoder_weights(weights.spec_of(voc.model), SEED, CPU,
                                   config["vocoder"]["init"])}
    mel = torch.randn(2, 80, 48, generator=torch.Generator().manual_seed(SEED))
    got = ref.vocode(W["voc"], config["vocoder"]["generator"], mel, ref.Precision(precision))
    gap = sb.vocoder_gap(config, W, got, mel, CPU)
    assert gap > cell["limits"]["voc_gap"], gap


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tiny_cell_runs_on_the_card(card):
    from versband_tpu_torch.device import resolve_device

    resolve_device(card)
    cell = _tiny()
    ok, lines = compare.judge(_checks(cell, card), cell["limits"])
    assert ok, lines
