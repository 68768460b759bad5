"""How ``CFMSampler`` decides between the eager Euler loop and a CUDA graph
(``models/cfm.py``: ``takes_graph``, ``graph_inputs``, ``graph_key``,
``GraphSlots``), checked without a card: which backbones and devices take the
graph, what a graph is keyed on, which call runs eagerly, captures or
replays, and that the sampler on the CPU is the eager loop bit for bit. The
capture and replay themselves run on the card (``test_torch_port_cuda.py``).
"""

import numpy as np
import pytest
import torch

from versband_tpu_torch.models.cfm import (
    CFM, CFMSampler, GraphSlots, euler_cfg_sample, graph_inputs, graph_key, takes_graph)
from versband_tpu_torch.models.dit import BandMoeDiT
from versband_tpu_torch.models.dit_timefreq import TimeFreqMoeDiT
from versband_tpu_torch.utils import profiling

DIT = dict(in_channels=4, context_dim=16, hidden_size=16, depth=2, num_heads=2, max_len=64,
           num_experts=2, ori_dim=12, multiple_of=8)
B, T_MEL = 2, 16
CUDA = torch.device("cuda")


def _cond(seed: int, B: int = B, caption_dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return {"caption": torch.from_numpy(rng.standard_normal((B, 5, 12))).to(caption_dtype),
            "acoustic": {"midi": torch.from_numpy(rng.integers(0, 128, (B, 1, T_MEL))),
                         "beats": torch.from_numpy(rng.integers(0, 2, (B, 1, T_MEL)))},
            "name": ["a"] * B}


def _key(B=B, dtype=torch.float32, uncond=True, scale=2.0, steps=25, t_start=0):
    x0 = torch.zeros(B, 4, T_MEL // 2, dtype=dtype)
    use_cfg = uncond and scale != 1.0
    inputs = graph_inputs(x0, _cond(0, B, dtype), _cond(1, B, dtype) if uncond else None,
                          use_cfg)
    return graph_key(inputs, use_cfg, scale, steps, t_start, 1000)


@pytest.mark.parametrize("change", [dict(B=4), dict(dtype=torch.bfloat16), dict(uncond=False),
                                    dict(scale=3.0), dict(steps=10), dict(t_start=3)],
                         ids=["shape", "dtype", "cfg_off", "guidance_scale", "num_steps",
                              "t_start"])
def test_the_key_changes_with_each_input_of_the_captured_work(change):
    assert _key() == _key()
    assert _key(**change) != _key()


def test_without_cfg_the_uncond_is_no_input():
    x0 = torch.zeros(B, 4, T_MEL // 2)
    names = [n for n, _ in graph_inputs(x0, _cond(0), _cond(1), False)]
    assert names == [("x0",), ("cond", "caption"), ("cond", "acoustic", "midi"),
                     ("cond", "acoustic", "beats")]
    assert len(graph_inputs(x0, _cond(0), _cond(1), True)) == 2 * len(names) - 1
    # guidance 1.0 with an uncond given samples as without one
    assert _key(scale=1.0) == _key(uncond=False, scale=1.0)


def test_the_first_call_runs_eagerly_the_second_captures_then_replays():
    slots = GraphSlots()
    assert [slots.decide("a"), slots.decide("b"), slots.decide("a")] == \
        ["eager", "eager", "capture"]
    slots.put("a", "graph a")
    assert [slots.decide("a"), slots.decide("a"), slots.decide("b")] == \
        ["replay", "replay", "capture"]
    slots.put("b", "graph b")
    slots.clear()  # a parameter's storage was replaced: warm again, then capture
    assert [slots.decide("a"), slots.decide("a")] == ["eager", "capture"]


def test_the_slots_stay_within_their_size():
    slots = GraphSlots(size=3)
    for k in range(10):
        assert slots.decide(k) == "eager"
        assert len(slots.seen) <= 3
    for k in range(10):
        assert slots.decide(("g", k)) == "eager" and slots.decide(("g", k)) == "capture"
        slots.put(("g", k), k)
        assert len(slots.graphs) <= 3
    assert list(slots.graphs) == [("g", 7), ("g", 8), ("g", 9)]
    assert slots.decide(("g", 8)) == "replay"  # used last, so dropped last
    assert [slots.decide(("g", 10)), slots.decide(("g", 10))] == ["eager", "capture"]
    slots.put(("g", 10), 10)
    assert list(slots.graphs) == [("g", 9), ("g", 8), ("g", 10)]


def _routed_dit():
    return BandMoeDiT(**DIT, moe_eval_routed=True)


def _legacy():
    return TimeFreqMoeDiT(in_channels=4, context_dim=12, hidden_size=16, depth=2, num_heads=2,
                          max_len=32, num_experts=4, multiple_of=8)


@pytest.mark.parametrize("make,device,want", [
    (lambda: BandMoeDiT(**DIT), CUDA, True),
    (lambda: BandMoeDiT(**DIT), torch.device("cpu"), False),
    (_routed_dit, CUDA, False),
    (_legacy, CUDA, False),
], ids=["dense_on_a_card", "dense_on_the_cpu", "moe_eval_routed", "legacy"])
def test_only_a_dense_band_moe_dit_on_a_card_takes_the_graph(make, device, want):
    assert takes_graph(make(), device) is want


def test_the_sampler_on_the_cpu_is_the_eager_loop_bit_for_bit():
    torch.manual_seed(0)
    cfm = CFM(unet_config=dict(target="versband_tpu.models.dit.BandMoeDiT", params=DIT),
              mel_dim=4, device="cpu")
    with torch.no_grad():
        for name, p in cfm.model.named_parameters():  # adaLN-zero: off zero
            if "adaLN" in name or "final_layer" in name or name.endswith("gate"):
                p.copy_(torch.randn(p.shape) * 0.02)
    sampler = CFMSampler(cfm, num_timesteps=5)
    x0 = torch.randn(B, 4, T_MEL // 2, generator=torch.Generator().manual_seed(3))
    c, uc = _cond(0), _cond(1)
    want = euler_cfg_sample(cfm.model, x0, c, uc, 2.0, num_steps=5, encode_once=True)
    profiling.spans_on()
    try:
        got = [sampler.sample_cfg(c, 2.0, uc, batch_size=B, x_latent=x0) for _ in range(3)]
    finally:
        profiling.spans_off()
    spans, counts = profiling.drain()
    for z in got:
        assert torch.equal(z, want)
    assert not torch.equal(want, x0)
    assert not sampler.graphs.seen and not sampler.graphs.graphs
    assert not any(k.startswith("models.cfm.graph") for k in counts)
    assert sum(s.name == "models.cfm.euler_step" for s in spans) == 3 * 4
