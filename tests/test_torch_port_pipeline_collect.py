"""``sample/pipeline.py::PipelinedGenerator`` on CPU tensors: at every depth
the requests come back in order with the values ``.float().cpu().numpy()``
gives, request i only after request i + depth - 1's sampler was queued; each
stage is queued in the documented order (from depth 2 a request's decode and
vocode after the previous request is handed back, before the next request is
taken); one ``sample.pipeline.collect`` span is tagged with each request's
index, and neither collect counter moves (a CPU output takes no pinned copy).
The pinned copy and its event are held to the same values on the card in
``tests/test_torch_port_cuda.py``."""

import numpy as np
import pytest
import torch

from versband_tpu_torch.sample.pipeline import PipelinedGenerator
from versband_tpu_torch.utils import profiling

REQUESTS = 5
COUNTERS = ("sample.pipeline.collect.async", "sample.pipeline.collect.waited")


@pytest.fixture(autouse=True)
def clean():
    profiling.spans_off()
    profiling.drain()
    yield
    profiling.spans_off()
    profiling.drain()


def _take(i: int) -> torch.Tensor:
    return torch.randn(2, 37, generator=torch.Generator().manual_seed(i)).to(torch.bfloat16)


def _serve(depth: int, vocode: bool):
    issued, got = [], []

    def sample(i, _generator):
        issued.append(i)
        return _take(i)

    pipe = PipelinedGenerator(sample, lambda z: z * 2, (lambda mel: mel - 1) if vocode else None,
                              depth=depth)
    for i, out in enumerate(pipe.generate((i, None) for i in range(REQUESTS))):
        assert len(issued) == min(i + depth, REQUESTS)
        got.append(out)
    return got


@pytest.mark.parametrize("vocode", [True, False])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_order_and_values_at_every_depth(depth, vocode):
    got = _serve(depth, vocode)
    assert len(got) == REQUESTS
    for i, out in enumerate(got):
        want = _take(i) * 2
        want = want - 1 if vocode else want
        assert out.dtype == np.float32
        assert np.array_equal(out, want.float().cpu().numpy())


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_one_collect_span_per_request_and_no_counter_on_the_cpu(depth):
    profiling.spans_on()
    _serve(depth, True)
    spans, counts = profiling.drain()
    collects = [s for s in spans if s.name == "sample.pipeline.collect"]
    assert [s.id for s in collects] == list(range(REQUESTS))
    assert not set(COUNTERS) & set(counts)


# the order of the pipeline's calls at 3 requests: p pull, s sample, d decode,
# v vocode, y the output yielded, each with its request
ORDER = {
    1: "p0 s0 d0 v0 y0 p1 s1 d1 v1 y1 p2 s2 d2 v2 y2",
    2: "p0 s0 d0 v0 p1 s1 y0 d1 v1 p2 s2 y1 d2 v2 y2",
    3: "p0 s0 d0 v0 p1 s1 d1 v1 p2 s2 y0 d2 v2 y1 y2",
}


@pytest.mark.parametrize("depth", sorted(ORDER))
def test_each_stage_is_queued_in_the_documented_order(depth):
    log = []

    def stage(name, f):
        def run(x, *_):
            log.append(f"{name}{int(x.flatten()[0]) % 10}")
            return f(x)
        return run

    def requests():
        for i in range(3):
            log.append(f"p{i}")
            yield torch.full((2,), float(i)), None

    pipe = PipelinedGenerator(stage("s", lambda c: c + 10), stage("d", lambda z: z + 10),
                              stage("v", lambda m: m + 10), depth=depth)
    for out in pipe.generate(requests()):
        log.append(f"y{int(out[0]) % 10}")
    assert " ".join(log) == ORDER[depth]
