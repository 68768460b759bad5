"""Pipelined multi-song inference (port of ``versband_tpu/sample/pipeline.py``).

The serving shape: sampler -> VAE decode -> vocoder per request. CUDA work is
asynchronous, so queueing request i+1's work while the card still runs
request i keeps the card fed. On the card each request ends in its own
non-blocking copy into pinned host memory and an event recorded after it;
collecting the request waits on that event alone, so the host takes request
i back (and the caller normalises it) while the card works on request i+1.
A CPU output is collected as it is.

At depth 2 and more, request i is collected once request i+1's sampler is
queued; request i+1's decode and vocode are queued when the caller asks for
the next output, before the request after it is taken. The sampler is most of
a request's card time, so the caller's work on request i runs beside it; and
a vocoder that queues many small kernels (four HiFi-GAN takes: more launches
than CUDA's launch queue holds) blocks the host only once the sampler is
nearly done, not before request i is handed back.

The spans of request i (the i-th of the stream) carry the tag i, and so does
the ``sample.pipeline.collect`` span that waits for it. Counters (while spans
are on): ``sample.pipeline.collect.async``, each collect from a pinned copy;
``sample.pipeline.collect.waited``, each of those whose copy had not finished
when it was asked for.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from versband_tpu_torch.utils.profiling import annotate, count, tag


def _to_host(index: int, x: torch.Tensor, done: Optional[torch.cuda.Event]) -> np.ndarray:
    with tag(index), annotate("sample.pipeline.collect"):
        if done is None:
            return x.float().cpu().numpy()
        count("sample.pipeline.collect.async")
        if not done.query():
            count("sample.pipeline.collect.waited")
        done.synchronize()
        return x.numpy()


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

    def _start(self, index: int, request: Tuple[Any, Optional[torch.Generator]]) -> Any:
        cond, generator = request
        with tag(index):
            return self.sample_fn(cond, generator)

    def _finish(self, index: int, z: Any
                ) -> Tuple[int, torch.Tensor, Optional[torch.cuda.Event]]:
        """The request's decode and vocode queued; its output, or on the card
        a pinned float32 buffer of its own with the event after the copy."""
        with tag(index):
            mel = self.decode_fn(z)
            x = self.vocode_fn(mel) if self.vocode_fn is not None else mel
            if not x.is_cuda:
                return index, x, None
            # a buffer per request: a later copy never writes into an array
            # the caller still holds
            buf = torch.empty(x.shape, dtype=torch.float32, pin_memory=True)
            buf.copy_(x.float(), non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(x.device))
            return index, buf, done

    def generate(self, requests: Iterable[Tuple[Any, Optional[torch.Generator]]]
                 ) -> Iterator[np.ndarray]:
        """requests: (cond, generator) pairs, each taken when the pipeline has
        room for it. Yields host waveforms (or mels without a vocoder) in
        request order."""
        inflight: Deque[Tuple[int, torch.Tensor, Optional[torch.cuda.Event]]] = deque()
        for index, request in enumerate(requests):
            z = self._start(index, request)
            if inflight and len(inflight) + 1 >= self.depth:
                yield _to_host(*inflight.popleft())
            inflight.append(self._finish(index, z))
            if len(inflight) >= self.depth:  # depth 1
                yield _to_host(*inflight.popleft())
        while inflight:
            yield _to_host(*inflight.popleft())
