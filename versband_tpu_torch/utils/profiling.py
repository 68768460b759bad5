"""Profiling helpers (port of ``versband_tpu/utils/profiling.py``): a
``torch.profiler`` trace, per-step wall timing and device memory stats.

* ``trace(logdir)``: profiles the block (the CPU, and the card where there is
  one) and writes a Chrome trace (``trace.json``) into ``logdir``;
* ``StepTimer``: wall-clock seconds per step and their exponential moving
  average; ``stop(outputs)`` first waits for the CUDA devices the outputs
  live on (where the JAX twin calls ``block_until_ready``);
* ``device_memory_stats(device)``: MiB under JAX's names ``bytes_in_use`` and
  ``peak_bytes_in_use`` (``memory_allocated`` / ``max_memory_allocated``) plus
  every ``*bytes*`` counter of ``torch.cuda.memory_stats``; ``{}`` for a
  device without stats (the CPU), as JAX returns;
* ``annotate(name)``: a named region of the trace (``record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch

MIB = 1024 ** 2


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; its Chrome trace lands in ``logdir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
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


def annotate(name: str):
    """A named region of the profiler's timeline."""
    return torch.profiler.record_function(name)
