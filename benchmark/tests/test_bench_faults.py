"""The serve driver at tiny widths on the CPU, with the timed path broken
underneath, must come out not correct; sound, it comes out correct. The
harness's look for a card is skipped: the driver is called directly."""

import time

import pytest
import torch

from benchmark.drivers import serve
from benchmark.lib import compare
from benchmark.reference import models as ref
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def _judge(cell):
    out = serve.run(cell, SEED, 0.5, False, time.perf_counter(), CPU)
    ok, _ = compare.judge(out["checks"], cell["limits"])
    return ok, out["checks"]


def _state_unchanged(monkeypatch):
    """Every Euler step returns its state unchanged: a zero flow field."""
    from versband_tpu_torch.models.dit import BandMoeDiT

    forward = BandMoeDiT.forward

    def frozen(self, x, t, context, **kw):
        out = forward(self, x, t, context, **kw)
        return out if context.get("encode_only") else (torch.zeros_like(out[0]), out[1])

    monkeypatch.setattr(BandMoeDiT, "forward", frozen)


def _half_batch_left_out(monkeypatch):
    """The CFG batch's unconditional half left out: the conditional half alone."""
    from versband_tpu_torch.models import cfm

    sample = cfm.euler_cfg_sample
    monkeypatch.setattr(cfm, "euler_cfg_sample",
                        lambda model, x0, cond, uncond=None, guidance_scale=1.0, **kw:
                        sample(model, x0, cond, None, 1.0, **kw))


def _answer_altered(monkeypatch):
    """A hundredth of each waveform negated where the vocoder produces it."""
    from versband_tpu_torch.vocoder.hifigan import HifiGAN

    waveform = HifiGAN.waveform

    def altered(self, mel):
        out = waveform(self, mel).clone()
        out[..., : out.shape[-1] // 100] *= -1
        return out

    monkeypatch.setattr(HifiGAN, "waveform", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch_left_out, _answer_altered])
def test_a_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    ok, checks = _judge(tiny_cell())
    assert not ok, checks


def test_sound_run_is_correct():
    ok, checks = _judge(tiny_cell())
    assert ok, checks


def test_control_is_not_correct():
    """The reference with its products in float8 in the program's place."""
    cell = tiny_cell()
    config, mix = cell["config_data"], cell["traffic_data"]
    prog = serve.Program(config, mix, SEED, CPU)
    W = serve.reference_weights(prog.specs, SEED, CPU)
    clips = serve.Clips(mix, SEED)
    gaps = dict.fromkeys(serve.STAGES, 0.0)
    for i in range(2):
        want = serve.reference_outputs(config, mix, W, clips[i], clips.T, CPU)
        got = serve.reference_outputs(config, mix, W, clips[i], clips.T, CPU, "fp8")
        for k, v in serve.stage_gaps(got, want).items():
            gaps[k] = max(gaps[k], v)
    ok, _ = compare.judge({**gaps, "missing_requests": 0.0, "failed_requests": 0.0},
                          cell["limits"])
    assert not ok, gaps
    assert ref.Precision("fp8").q(torch.tensor([448.0, 1.1])).tolist() == [448.0, 1.125]


def test_tower_control_is_not_correct():
    """The reference's caption tower with its products in TF32 in the
    float32 tower's place fails ``cond_gap``: at the cell's own tower (24
    blocks at flan-t5-large's widths, 80 tokens), since a random tower's
    blocks amplify a rounding layer by layer, and at 2 tiny blocks they do
    not (there TF32 reads about 2e-3)."""
    from benchmark.lib import cells, weights
    from versband_tpu_torch.text.t5 import T5Encoder

    config = cells.cell("accomp_band.serve")["config_data"]
    params = config["model"]["params"]["cond_stage_config"]["params"]
    with torch.device("meta"):
        spec = weights.spec_of(T5Encoder(params["fallback_config"]))
    W = {"t5": weights.make(spec, SEED, "t5", CPU)}
    req = serve.Clips(tiny_cell()["traffic_data"], SEED)[0]
    gap = serve.tower_control_gap(config, W, req, CPU)
    assert gap > cells.cell("accomp_band.serve")["limits"]["cond_gap"], gap
    x = torch.tensor([1.0 + 2 ** -12, 3.14159265])
    assert ref.Precision("tf32").q(x).tolist() == [1.0, 3.140625]
