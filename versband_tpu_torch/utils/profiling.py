"""Profiling helpers (port of ``versband_tpu/utils/profiling.py``): the
program's spans and counters, a ``torch.profiler`` trace, per-step wall
timing and device memory stats.

* ``annotate(name)``: the program's span, a named region of its host time.
  While spans are off (the default) it costs one flag check and returns a
  shared null context. While they are on (``spans_on()``, or inside
  ``trace``) it keeps ``Span(name, start_ns, end_ns, tid, thread, parent,
  id, ident)`` in memory when the region ends: ``time.time_ns()`` (the
  clock the profiler's events are stamped in), the thread's native id and
  name, the index of the span open on the same thread when this one began
  (-1: none), the request or step ``tag`` in force, and the thread's
  ``threading.get_ident()`` (``pthread_self``, whose low 32 bits a CUDA
  runtime event of the profiler carries as its ``device_resource_id``).
  Inside ``trace`` it also enters ``record_function``, so the Chrome trace
  shows the same regions;
* ``tag(id)``: the request or step the spans begun on this thread inside
  the block belong to;
* ``count(name, n=1)``: an in-memory counter, recorded while spans are on;
* ``drain()``: the spans (in order of their start) and counters recorded
  since the last drain, which it clears. Spans still open are left for the
  next drain;
* ``trace(logdir)``: profiles the block (the CPU, and the card where there is
  one) with spans on and writes a Chrome trace (``trace.json``) into ``logdir``;
* ``StepTimer``: wall-clock seconds per step and their exponential moving
  average; ``stop(outputs)`` first waits for the CUDA devices the outputs
  live on (where the JAX twin calls ``block_until_ready``);
* ``device_memory_stats(device)``: MiB under JAX's names ``bytes_in_use`` and
  ``peak_bytes_in_use`` (``memory_allocated`` / ``max_memory_allocated``) plus
  every ``*bytes*`` counter of ``torch.cuda.memory_stats``; ``{}`` for a
  device without stats (the CPU), as JAX returns.

Spans and counters live in this module, one record for the process: there is
no file and no switch outside the calls above.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

MIB = 1024 ** 2

_ON = False  # spans and counters are recorded
_TRACING = False  # ``trace`` records: spans enter ``record_function`` too
_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()
_SERIAL = itertools.count()
_LOCAL = threading.local()  # per thread: ``open`` (serials of open spans), ``id``
# finished spans: (name, start_ns, end_ns, tid, thread, parent serial, id, ident, serial)
_SPANS: List[tuple] = []
_COUNTS: Dict[str, int] = {}


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    tid: int  # ``threading.get_native_id()``
    thread: str
    parent: int  # index in the same drain of the span it began inside, -1: none
    id: Any  # the ``tag`` in force when it began
    ident: int  # ``threading.get_ident()``


class _Span:
    __slots__ = ("name", "t0", "serial", "parent", "id", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        local = _LOCAL.__dict__
        stack = local.setdefault("open", [])
        self.parent = stack[-1] if stack else -1
        self.id = local.get("id")
        self.serial = next(_SERIAL)
        stack.append(self.serial)
        self.rf = None
        if _TRACING:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _LOCAL.open.pop()
        rec = (self.name, self.t0, t1, threading.get_native_id(),
               threading.current_thread().name, self.parent, self.id, threading.get_ident(),
               self.serial)
        with _LOCK:
            _SPANS.append(rec)
        return False


class _Tag:
    __slots__ = ("id", "prev")

    def __init__(self, id: Any):
        self.id = id

    def __enter__(self):
        local = _LOCAL.__dict__
        self.prev = local.get("id")
        local["id"] = self.id
        return self

    def __exit__(self, *exc):
        _LOCAL.id = self.prev
        return False


def annotate(name: str):
    """The program's span ``name`` around the block (a null context while
    spans are off)."""
    if not _ON:
        return _NULL
    return _Span(name)


def tag(id: Any):
    """Spans begun on this thread inside the block carry ``id`` (a null
    context while spans are off)."""
    if not _ON:
        return _NULL
    return _Tag(id)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while spans are on."""
    if _ON:
        with _LOCK:
            _COUNTS[name] = _COUNTS.get(name, 0) + n


def spans_on() -> None:
    global _ON
    _ON = True


def spans_off() -> None:
    global _ON
    _ON = False


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """The finished spans, by start, and the counters; both cleared."""
    global _SPANS, _COUNTS
    with _LOCK:
        recs, _SPANS = _SPANS, []
        counts, _COUNTS = _COUNTS, {}
    recs.sort(key=lambda r: (r[1], r[8]))
    index = {r[8]: i for i, r in enumerate(recs)}
    return [Span(*r[:5], index.get(r[5], -1), r[6], r[7]) for r in recs], counts


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with spans on; its Chrome trace lands in
    ``logdir/trace.json``. The spans stay in memory for ``drain``."""
    global _ON, _TRACING
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = _ON, _TRACING
    with torch.profiler.profile(activities=activities) as prof:
        _ON = _TRACING = True
        try:
            yield prof
        finally:
            _ON, _TRACING = was
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _cuda_devices(outputs: Any) -> set:
    if torch.is_tensor(outputs):
        return {outputs.device} if outputs.is_cuda else set()
    if isinstance(outputs, dict):
        outputs = list(outputs.values())
    if isinstance(outputs, (list, tuple)):
        return set().union(*[_cuda_devices(o) for o in outputs]) if outputs else set()
    return set()


class StepTimer:
    """Wall-clock seconds per step; ``avg`` is their EMA (the first step
    sets it)."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, outputs: Any = None) -> float:
        for dev in _cuda_devices(outputs):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else self.ema * self.avg + (1 - self.ema) * dt
        return dt


def device_memory_stats(device: Any = None) -> Dict[str, float]:
    """Current and peak memory of a CUDA device in MiB (``{}`` for others)."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        return {}
    out = {k: v / MIB for k, v in torch.cuda.memory_stats(dev).items()
           if isinstance(v, (int, float)) and "bytes" in k}
    out["bytes_in_use"] = torch.cuda.memory_allocated(dev) / MIB
    out["peak_bytes_in_use"] = torch.cuda.max_memory_allocated(dev) / MIB
    return out
