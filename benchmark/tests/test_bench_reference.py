"""The plain reference against the port at tiny widths on the CPU: the
serving path in float32 through the driver, every stage the comparison
covers; the seed-made weights repeat and differ by seed."""

import time

import pytest
import torch

from benchmark.drivers import serve
from benchmark.lib import weights
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("takes", [1, 2])
def test_reference_follows_the_port_in_float32(takes):
    cell = tiny_cell(takes=takes)
    cell["config_data"]["serve_dtype"] = "float32"
    out = serve.run(cell, 2 ** 31 + 5, 0.5, False, time.perf_counter(), CPU)
    checks = out["checks"]
    assert checks["missing_requests"] == 0 and checks["failed_requests"] == 0
    for stage in serve.STAGES:
        assert checks[stage] < 1e-5, (stage, checks[stage])


def test_weights_repeat_and_differ_by_seed():
    spec = [("a.weight", (4, 3)), ("a.bias", (4,)), ("n.weight", (3,))]
    w1 = weights.make(spec, 9, "m", CPU)
    assert all(torch.equal(w1[k], weights.make(spec, 9, "m", CPU)[k]) for k in w1)
    assert not torch.equal(w1["a.weight"], weights.make(spec, 10, "m", CPU)["a.weight"])
    assert not torch.equal(w1["a.weight"], weights.make(spec, 9, "other", CPU)["a.weight"])
    assert (w1["n.weight"] - 1).abs().max() < 1


def test_fill_copies_what_make_draws():
    module = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.LayerNorm(4)).to(torch.bfloat16)
    spec = weights.spec_of(module)
    weights.fill(module, spec, 4, "m", CPU)
    want = weights.make(spec, 4, "m", CPU)
    for k, p in module.named_parameters():
        assert torch.equal(p, want[k].to(torch.bfloat16))
