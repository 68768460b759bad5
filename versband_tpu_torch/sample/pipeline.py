"""Pipelined multi-song inference (port of ``versband_tpu/sample/pipeline.py``).

The serving shape: sampler -> VAE decode -> vocoder per request. CUDA work is
asynchronous, so issuing the stages of request i+1 while the card still runs
request i keeps the card fed; the host blocks only when it collects the
oldest finished waveform (the copy to host memory waits for it). The spans
of request i (the i-th of the stream) carry the tag i, and so does the
``sample.pipeline.collect`` span that waits for it.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from versband_tpu_torch.utils.profiling import annotate, tag


def _to_host(index: int, x: torch.Tensor) -> np.ndarray:
    with tag(index), annotate("sample.pipeline.collect"):
        return x.float().cpu().numpy()


class PipelinedGenerator:
    """Overlap sample/decode/vocode across a request stream.

    ``sample_fn(cond, generator) -> z``; ``decode_fn(z) -> mel``;
    ``vocode_fn(mel) -> wav``; each queues its work and returns device
    tensors without waiting. ``depth`` bounds the requests in flight.
    """

    def __init__(self, sample_fn: Callable, decode_fn: Callable,
                 vocode_fn: Optional[Callable] = None, depth: int = 2):
        self.sample_fn = sample_fn
        self.decode_fn = decode_fn
        self.vocode_fn = vocode_fn
        self.depth = max(1, depth)

    def _issue(self, index: int, request: Tuple[Any, Optional[torch.Generator]]
               ) -> torch.Tensor:
        cond, generator = request
        with tag(index):
            mel = self.decode_fn(self.sample_fn(cond, generator))
            return self.vocode_fn(mel) if self.vocode_fn is not None else mel

    def generate(self, requests: Iterable[Tuple[Any, Optional[torch.Generator]]]
                 ) -> Iterator[np.ndarray]:
        """requests: (cond, generator) pairs. Yields host waveforms (or mels
        without a vocoder) in request order."""
        inflight: Deque[Tuple[int, torch.Tensor]] = deque()
        for index, req in enumerate(requests):
            inflight.append((index, self._issue(index, req)))
            if len(inflight) >= self.depth:
                yield _to_host(*inflight.popleft())
        while inflight:
            yield _to_host(*inflight.popleft())
