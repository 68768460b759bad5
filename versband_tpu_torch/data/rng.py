"""Thread-safe per-dataset randomness for the threaded loader (port of
``versband_tpu/data/rng.py``).

numpy ``Generator`` objects are not thread-safe, and
:class:`versband_tpu_torch.data.datamodule.DataLoader` maps ``dataset[i]``
across a thread pool. ``ThreadLocalRNG`` gives each loader thread its own
stream, ``default_rng([seed, n])`` with ``n`` the thread's order of first
use, and passes the whole Generator API through to it.
"""

from __future__ import annotations

import itertools
import threading

import numpy as np


class ThreadLocalRNG:
    def __init__(self, seed=0):
        if seed is None:  # as default_rng(None): fresh OS entropy
            seed = int(np.random.SeedSequence().generate_state(1)[0])
        self._seed = int(seed)
        self._local = threading.local()
        self._counter = itertools.count()
        self._lock = threading.Lock()

    def _generator(self) -> np.random.Generator:
        rng = getattr(self._local, "rng", None)
        if rng is None:
            with self._lock:
                n = next(self._counter)
            rng = np.random.default_rng([self._seed, n])
            self._local.rng = rng
        return rng

    def __getattr__(self, name):
        return getattr(self._generator(), name)
