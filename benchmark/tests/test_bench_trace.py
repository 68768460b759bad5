"""The trace reduction on a hand-made trace: device operations go to the
span whose runtime call launched them, busy time is a union, idle gaps are
labelled by the host's span."""

import pytest

from benchmark.lib.trace import WINDOW, summarize


class Ev:
    def __init__(self, dev, name, start, dur, corr, linked=0):
        self.dev, self._name, self.s, self.d, self.c, self.l = dev, name, start, dur, corr, linked

    def device_type(self):
        return f"DeviceType.{self.dev}"

    def name(self):
        return self._name

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.c

    def linked_correlation_id(self):
        return self.l

    def is_user_annotation(self):
        return False


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": staticmethod(lambda: events)})})


def test_summarize_links_ops_to_the_span_that_launched_them():
    events = [Ev("CPU", "cudaLaunchKernel", 110, 5, 1), Ev("CUDA", "k_a", 150, 100, 1),
              Ev("CPU", "cudaLaunchKernel", 120, 5, 2), Ev("CUDA", "k_a", 200, 100, 2),
              Ev("CPU", "cuLaunchKernelEx", 410, 5, 3), Ev("CUDA", "k_b", 600, 50, 0, 3)]
    spans = [(WINDOW, 100, 700), ("sampler", 105, 400), ("decode", 400, 500)]
    t = summarize(Prof(events), spans)
    assert t["busy_s"] == pytest.approx(200e-9)
    assert t["window_s"] == pytest.approx(600e-9)
    assert t["spans"]["sampler"]["busy_s"] == pytest.approx(150e-9)
    assert t["spans"]["decode"]["busy_s"] == pytest.approx(50e-9)
    assert t["spans"]["sampler"]["host_s"] == pytest.approx(295e-9)
    assert t["linked_share"] == 1.0
    assert t["ops"]["k_a"] == {"count": 2, "seconds": pytest.approx(200e-9)}
    gaps = dict(t["breakdown"]["idle_gaps"])
    # idle 100-150 (no span to 105), 300-600 (sampler to 400, decode to 500), 650-700
    assert gaps["sampler"] == pytest.approx(145e-9)
    assert gaps["decode"] == pytest.approx(100e-9)
    assert gaps["(no span)"] == pytest.approx(155e-9)
    assert summarize(Prof([]), spans) is None
