"""The program's spans reduced against a hand-made two-thread trace
(``benchmark/lib/program_trace.py``): each device operation goes to the
innermost program span of the thread that launched it, idle gaps take the
main thread's innermost span, and what ``trace.summarize`` gives, with every
accepted metric read from it, stays as it was."""

import pytest

from benchmark.lib import cells, program_trace
from benchmark.lib.trace import WINDOW, summarize
from versband_tpu_torch.utils.profiling import Span

# threads' ``threading.get_ident()`` (pthread_self), as a card's run read them
MAIN, WORKER, OTHER = 0x7FA3FF9A4300, 0x7FA08B1FF6C0, 0x7FA0123456C0


class Ev:
    def __init__(self, dev, name, start, dur, corr, tid=0, linked=0):
        self.dev, self._name, self.s, self.d, self.c, self.t, self.l = \
            dev, name, start, dur, corr, tid, linked

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

    def start_thread_id(self):
        return 1  # what a CUDA-only trace reads for every thread

    def device_resource_id(self):
        return program_trace.runtime_thread(self.t)

    def is_user_annotation(self):
        return False


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": staticmethod(lambda: events)})})


def _launch(t, corr, tid):
    return Ev("CPU", "cudaLaunchKernel", t, 5, corr, tid)


EVENTS = [_launch(160, 1, MAIN), Ev("CUDA", "k_fwd", 310, 90, 1),
          _launch(260, 2, WORKER), Ev("CUDA", "k_tower", 400, 50, 2),
          _launch(350, 3, MAIN), Ev("CUDA", "k_step", 450, 30, 3),
          _launch(420, 4, WORKER), Ev("CUDA", "k_copy", 480, 40, 4),
          _launch(700, 5, MAIN), Ev("CUDA", "k_late", 700, 20, 5),
          _launch(550, 6, OTHER), Ev("CUDA", "k_other", 560, 20, 6),
          _launch(320, 7, OTHER), Ev("CUDA", "k_bwd", 600, 30, 7)]
BENCH = [(WINDOW, 0, 1000), ("models.cfm.sampler", 90, 600)]
PROGRAM = [Span("train.step", 100, 500, 11, "MainThread", -1, 7, MAIN),
           Span("train.step.forward", 150, 300, 11, "MainThread", 0, 7, MAIN),
           Span("train.assemble", 200, 450, 12, "cfm-xfer_0", -1, None, WORKER),
           Span("text.tower", 250, 400, 12, "cfm-xfer_0", 2, None, WORKER)]
COUNTERS = {"data.loader.batches": 4, "data.loader.waited": 1}


def _both():
    plain = summarize(Prof(EVENTS), BENCH)
    full = program_trace.summarize(Prof(EVENTS), BENCH, PROGRAM, COUNTERS, main_ident=MAIN)
    return plain, full


def test_operations_go_to_the_launching_threads_innermost_span():
    _, t = _both()
    p = t["program"]
    assert p["train.step.forward"]["busy_s"] == pytest.approx(90e-9)
    # k_step launched on the main thread while the worker's tower span was the latest
    # begun; k_bwd from a thread with no span (autograd's) while train.step was open
    assert p["train.step"]["busy_s"] == pytest.approx(60e-9)
    assert p["text.tower"]["busy_s"] == pytest.approx(50e-9)
    assert p["train.assemble"]["busy_s"] == pytest.approx(40e-9)
    assert p["train.step"]["host_s"] == pytest.approx(400e-9)
    assert all(d["count"] == 1 for d in p.values())
    assert t["counters"] == COUNTERS
    # k_other went to the driver's sampler span by time, k_late to no span
    assert t["links"] == {"linked_share": pytest.approx(6 / 7), "moved": 1,
                          "unknown_thread": 2}
    notes = program_trace.notes(t)
    assert notes[0].startswith("traced: 0.8571 of the device operations")
    assert "(1 launched during such a span" in notes[1] and "; 2 launched" in notes[1]


def test_idle_gaps_take_the_main_threads_innermost_span():
    plain, t = _both()
    gaps = dict(t["breakdown"]["idle_gaps"])
    assert gaps == {"(no span)": pytest.approx(440e-9), "train.step.forward":
                    pytest.approx(150e-9), "models.cfm.sampler": pytest.approx(70e-9),
                    "train.step": pytest.approx(60e-9)}
    assert dict(plain["breakdown"]["idle_gaps"]) == {
        "(no span)": pytest.approx(440e-9), "models.cfm.sampler": pytest.approx(280e-9)}
    assert sum(gaps.values()) == pytest.approx(t["window_s"] - t["busy_s"])


def test_the_benchmarks_own_reduction_and_metrics_are_unchanged():
    plain, full = _both()
    for k in plain:
        if k != "breakdown":
            assert full[k] == plain[k], k
    assert full["breakdown"]["device_ops"] == plain["breakdown"]["device_ops"]
    extra = dict(requests=2, takes=1, steps=2, flops=1e3, peak_flops=1e12, k1_bound_ms=1e-4,
                 attn_bound_ms=1e-4)
    read = 0
    for m in cells.benchmark()["per_layer"]:
        reader = cells.metric_reader(m["name"])
        want = reader({**plain, **extra})
        assert reader({**full, **extra}) == want, m["name"]
        read += want is not None
    assert read >= 5


def test_runtime_thread_is_pthread_selfs_low_word_signed():
    assert program_trace.runtime_thread(0x7FA3FF9A4300) == -6667520
    assert program_trace.runtime_thread(0x7FA08B1FF6C0) == -1960839488
    assert program_trace.runtime_thread(0x12345678) == 0x12345678


def test_no_window_or_no_device_work_gives_none():
    assert program_trace.summarize(Prof([]), BENCH, PROGRAM, {}) is None
    assert program_trace.summarize(Prof(EVENTS), BENCH[1:], PROGRAM, {}) is None
