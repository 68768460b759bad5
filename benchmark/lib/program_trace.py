"""The program's own spans and counters (``versband_tpu_torch/utils/profiling.py``:
``annotate``, ``count``, ``drain``) reduced against the same ``torch.profiler``
trace as the benchmark's spans (``benchmark/lib/trace.py``).

``summarize`` returns ``trace.summarize``'s result unchanged but for
``breakdown.idle_gaps``, plus:

* ``program``: ``{name: {host_s, busy_s, count}}`` per program span name. A
  device operation goes to the innermost program span open, when the runtime
  call that launched it was made, on the thread that made it, so kernels a
  worker thread launches during a span of the main thread land on the
  worker's span. The runtime event names its thread by ``pthread_self``'s
  low 32 bits, signed, as ``device_resource_id()`` (its ``start_thread_id()``
  reads 1 for every thread under a CUDA-only trace: torch 2.11, H100); a
  span carries that thread's ``threading.get_ident()``. A thread that
  records no span is autograd's device thread, which runs a ``backward()``
  or ``autograd.grad`` for the thread blocked in it: its operations go to
  the main thread's innermost span;
* ``counters``: the program's counters, as drained;
* ``links``: how the device operations were linked: the share linked to a
  span of the program or of the driver; ``moved``, those a thread that
  records spans launched while another such thread's span was the latest
  begun (a link by time alone would have put them there; none goes to
  another such thread's span); ``unknown_thread``, those launched from a
  thread that records no span.

``breakdown.idle_gaps`` labels each stretch of the window in which the card
ran nothing by the innermost span then open on the main thread, the
program's or the driver's.
"""

from __future__ import annotations

import bisect
import collections
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from benchmark.lib import arith
from benchmark.lib.trace import WINDOW, _host_segments, _is_device, _is_launch, summarize as \
    bench_summarize


def _innermost(spans: Sequence[tuple], starts: List[int], t: int) -> int:
    """Index of the span of ``spans`` (one thread's, by start) that started
    last among those holding ``t``; -1 for none."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and not (spans[i][1] <= t <= spans[i][2]):
        i -= 1
    return i


def _idle_gaps(ops: List[Tuple[int, int]], segments: list, w0: int, w1: int) -> Dict[str, float]:
    """Seconds in which no operation ran, by the label of the host segment."""
    seg_starts = [g[0] for g in segments]
    gaps: Dict[str, float] = collections.defaultdict(float)
    cursor = w0
    for s, e in arith.union(ops) + [[w1, w1]]:
        if s > cursor:
            k = max(0, bisect.bisect_right(seg_starts, cursor) - 1)
            while k < len(segments) and segments[k][0] < s:
                a, b, label = segments[k]
                gaps[label] += max(0, min(b, s) - max(a, cursor)) / 1e9
                k += 1
        cursor = max(cursor, e)
    return gaps


def runtime_thread(ident: int) -> int:
    """What a runtime event's ``device_resource_id()`` reads for the thread
    whose ``threading.get_ident()`` is ``ident``."""
    low = ident & 0xFFFFFFFF
    return low - (1 << 32) if low >= 1 << 31 else low


def summarize(prof, spans: List[Tuple[str, int, int]], program: Sequence[Any],
              counters: Dict[str, int], main_ident: Optional[int] = None, top: int = 10
              ) -> Optional[Dict[str, Any]]:
    """``trace.summarize(prof, spans, top)`` with the program's ``program``
    spans (``profiling.Span``) and ``counters`` from one ``drain``;
    ``main_ident`` is the ``threading.get_ident()`` of the thread that ran
    the driver's spans (default: the main thread's)."""
    summary = bench_summarize(prof, spans, top)
    if summary is None:
        return None
    if main_ident is None:
        main_ident = threading.main_thread().ident
    main = runtime_thread(main_ident)
    w0, _ = next((s, e) for n, s, e in spans if n == WINDOW)
    launches, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        if _is_device(e):
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(),
                        e.linked_correlation_id()))
        elif _is_launch(e):
            launches[e.correlation_id()] = (e.start_ns(), e.device_resource_id())
    ops = [o for o in ops if o[1] > w0]
    w1 = w0 + round(summary["window_s"] * 1e9)

    # (name, start, end, index into ``program``), by start: every thread's, and each thread's
    every = sorted(((sp.name, sp.start_ns, sp.end_ns, i) for i, sp in enumerate(program)),
                   key=lambda x: x[1])
    every_starts = [x[1] for x in every]
    thread_of = [runtime_thread(sp.ident) for sp in program]
    by_thread: Dict[int, list] = collections.defaultdict(list)
    for x in every:
        by_thread[thread_of[x[3]]].append(x)
    starts = {tid: [x[1] for x in v] for tid, v in by_thread.items()}
    bench = sorted(((n, s, e) for n, s, e in spans if n != WINDOW), key=lambda x: x[1])
    bench_starts = [s for _, s, _ in bench]

    per_instance: Dict[int, list] = collections.defaultdict(list)
    linked = moved = unknown = 0
    for s, e, corr, linked_corr in ops:
        launch = launches.get(corr, launches.get(linked_corr))
        if launch is None:
            continue
        t, tid = launch
        if tid in by_thread:
            j = _innermost(every, every_starts, t)
            moved += j >= 0 and thread_of[every[j][3]] != tid
        else:
            unknown += 1
            tid = main
        mine = by_thread.get(tid)
        j = _innermost(mine, starts[tid], t) if mine else -1
        if j >= 0:
            per_instance[mine[j][3]].append((s, e))
            linked += 1
        else:
            linked += _innermost(bench, bench_starts, t) >= 0

    out: Dict[str, Dict[str, float]] = {}
    for i, sp in enumerate(program):
        d = out.setdefault(sp.name, {"host_s": 0.0, "busy_s": 0.0, "count": 0})
        d["host_s"] += (sp.end_ns - sp.start_ns) / 1e9
        d["busy_s"] += arith.busy_s(per_instance.get(i, []))
        d["count"] += 1

    main = sorted(bench + [(sp.name, sp.start_ns, sp.end_ns) for sp in program
                           if sp.ident == main_ident], key=lambda x: x[1])
    gaps = _idle_gaps([(s, e) for s, e, *_ in ops], _host_segments(main, w0, w1), w0, w1)
    summary["breakdown"]["idle_gaps"] = [[k, t] for k, t in
                                         sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]
    summary["program"] = out
    summary["counters"] = dict(counters)
    summary["links"] = {"linked_share": linked / len(ops) if ops else 0.0,
                        "moved": moved, "unknown_thread": unknown}
    return summary


def notes(summary: Dict[str, Any]) -> List[str]:
    """The lines a driver prints of ``summary["links"]``."""
    k = summary["links"]
    return [f"traced: {k['linked_share']:.4f} of the device operations linked to a span of "
            f"the program or the driver",
            f"traced: 0 device operations linked to a span of another thread that records "
            f"spans ({k['moved']} launched during such a span went to their own thread's); "
            f"{k['unknown_thread']} launched from a thread with none (autograd's) went to the "
            f"main thread's"]
