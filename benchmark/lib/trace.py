"""Spans of the benchmark's own and the reduction of a ``torch.profiler``
trace to what the per-layer metrics read.

The drivers wrap each call into a layer of the program in
``tracer.span(name)`` and the whole traced slice in ``tracer.span(WINDOW)``.
A span is the host's wall clock (``time.time_ns``, the clock the profiler's
events are stamped in) around the call; the profiler records the device
only (CUDA activity: kernels, copies and the runtime calls that launch
them), so that the host is not slowed by recording every operator.
``summarize`` links each device operation to the runtime call that launched
it (their correlation id), so each span gets the device time of the work it
queued, whenever the card ran it.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Any, Dict, List, Optional, Tuple

from benchmark.lib import arith

WINDOW = "bench.window"
NO_SPAN = "(no span)"


class _Span:
    __slots__ = ("tracer", "name", "t0")

    def __init__(self, tracer, name):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        self.tracer.spans.append((self.name, self.t0, time.time_ns()))


class Tracer:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.spans: List[Tuple[str, int, int]] = []

    def span(self, name: str):
        return _Span(self, name) if self.enabled else contextlib.nullcontext()


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA") and not e.is_user_annotation()


def _is_launch(e) -> bool:
    name = e.name()
    return str(e.device_type()).endswith("CPU") and (name.startswith("cuda")
                                                      or name.startswith("cu"))


def summarize(prof, spans: List[Tuple[str, int, int]], top: int = 10
              ) -> Optional[Dict[str, Any]]:
    """The traced slice: its length, device busy time, per-span host and
    device seconds, device time by operation name, idle gaps by what the
    host was doing, and the share of device operations linked to a span.
    None when the trace holds no window or no device work."""
    windows = [(s, e) for n, s, e in spans if n == WINDOW]
    spans = sorted(((n, s, e) for n, s, e in spans if n != WINDOW), key=lambda x: x[1])
    span_names = sorted({n for n, _, _ in spans})
    launches, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        if _is_device(e):
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                        e.correlation_id(), e.linked_correlation_id()))
        elif _is_launch(e):
            launches[e.correlation_id()] = e.start_ns()
    if not windows or not ops:
        return None
    w0, w1 = windows[0]
    ops = [o for o in ops if o[1] > w0]
    total = arith.busy_s((max(s, w0), e) for s, e, *_ in ops)
    w1 = max(w1, max(o[1] for o in ops))

    # each span instance gets the device operations launched inside it
    starts = [s[1] for s in spans]
    per_instance = collections.defaultdict(list)
    linked = 0
    for s, e, _, corr, linked_corr in ops:
        t = launches.get(corr, launches.get(linked_corr))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        # innermost span holding t: walk back over spans that started before it
        while i >= 0 and not (spans[i][1] <= t <= spans[i][2]):
            i -= 1
        if i >= 0:
            per_instance[i].append((s, e))
            linked += 1
    by_span: Dict[str, Dict[str, float]] = {n: {"host_s": 0.0, "busy_s": 0.0, "count": 0}
                                           for n in span_names}
    for i, (name, s, e) in enumerate(spans):
        d = by_span[name]
        d["host_s"] += (e - s) / 1e9
        d["busy_s"] += arith.busy_s(per_instance.get(i, []))
        d["count"] += 1

    by_op = collections.defaultdict(lambda: [0, 0.0])
    for s, e, name, *_ in ops:
        by_op[name][0] += 1
        by_op[name][1] += (e - s) / 1e9

    segments = _host_segments(spans, w0, w1)
    seg_starts = [g[0] for g in segments]
    gaps = collections.defaultdict(float)
    cursor = w0
    for s, e in arith.union((s, e) for s, e, *_ in ops) + [[w1, w1]]:
        if s > cursor:
            k = max(0, bisect.bisect_right(seg_starts, cursor) - 1)
            while k < len(segments) and segments[k][0] < s:
                a, b, label = segments[k]
                gaps[label] += max(0, min(b, s) - max(a, cursor)) / 1e9
                k += 1
        cursor = max(cursor, e)
    return {
        "window_s": (w1 - w0) / 1e9,
        "linked_share": linked / len(ops),
        "busy_s": total,
        "spans": by_span,
        "ops": {k: {"count": c, "seconds": t} for k, (c, t) in by_op.items()},
        "breakdown": {
            "device_ops": [[k, t] for k, (_, t) in
                           sorted(by_op.items(), key=lambda kv: -kv[1][1])[:top]],
            "idle_gaps": [[k, t] for k, t in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
        },
    }


def _host_segments(spans, w0: int, w1: int) -> list:
    """``[w0, w1]`` cut into ``(start, end, label)`` pieces, each labelled by
    the innermost span open on the host (the one that started last)."""
    points = sorted({w0, w1} | {t for _, s, e in spans for t in (s, e) if w0 < t < w1})
    out = []
    for a, b in zip(points, points[1:]):
        label = NO_SPAN
        for name, s, e in spans:
            if s > a:
                break
            if e >= b:
                label = name
        out.append((a, b, label))
    return out
