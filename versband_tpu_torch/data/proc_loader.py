"""Multi-process batch loading (port of ``versband_tpu/data/proc_loader.py``).

``ProcessDataLoader`` moves the item and collate work into persistent worker
processes, for datasets whose per-item Python work the GIL would serialise
in the threaded loader:

- workers use the ``spawn`` context, never ``fork``: a forked child of a
  process that has touched the card hangs or crashes. They start with
  ``CUDA_VISIBLE_DEVICES=""``, so nothing in them can open the card, and each
  rebuilds its own dataset from the pickled config;
- results are put back in sequence order, so the batch stream is the
  single-worker order whichever worker finishes first;
- jobs carry an epoch tag: an abandoned iteration's batches still in flight
  are dropped, never delivered to the next one;
- a worker's exception comes back with its traceback and is raised in the
  parent; a dead worker is noticed instead of hanging the trainer.
"""

from __future__ import annotations

import atexit
import os
import pickle
import queue as queue_mod
from typing import Any, Iterator, List, Optional


def _worker_main(cfg_blob: bytes, in_q, out_q, worker_id: int,
                 seed: Optional[int]) -> None:
    # hide the card before the dataset (or anything it imports) can touch
    # it: a worker must never open the parent's GPU
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from versband_tpu_torch.utils.config import instantiate_from_config

    try:
        cfg = pickle.loads(cfg_blob)
        if seed is not None:
            # distinct, deterministic stream per worker (crops / CFG dropout)
            cfg = dict(cfg)
            params = dict(cfg.get("params") or {})
            if "seed" in params and params["seed"] is not None:
                params["seed"] = int(params["seed"]) + worker_id
                cfg["params"] = params
        ds = instantiate_from_config(cfg)
    except Exception:
        import traceback

        out_q.put((-1, False, traceback.format_exc()))
        return
    collate = getattr(ds, "collater", None) or (lambda items: items)
    batch_loader = getattr(ds, "load_batch", None)
    while True:
        job = in_q.get()
        if job is None:
            return
        seq, idx_list = job
        try:
            if batch_loader is not None:
                batch = batch_loader(idx_list)
            else:
                batch = collate([ds[i] for i in idx_list])
            out_q.put((seq, True, batch))
        except Exception:
            import traceback

            out_q.put((seq, False, traceback.format_exc()))


class ProcessDataLoader:
    """Iterable over collated batches assembled by worker processes.

    ``dataset_cfg`` is an ``instantiate_from_config`` dict (each worker
    builds its own copy); ``batch_sampler`` yields index lists in the
    parent. ``prefetch`` batches are kept in flight across the pool
    (default: 2 per worker).
    """

    def __init__(self, dataset_cfg, batch_sampler, num_procs: int = 4,
                 prefetch: Optional[int] = None, seed: Optional[int] = 0,
                 result_timeout: float = 300.0):
        self.dataset_cfg = dataset_cfg
        self.batch_sampler = batch_sampler
        self.num_procs = max(1, int(num_procs))
        self.prefetch = prefetch if prefetch is not None else 2 * self.num_procs
        self.seed = seed
        self.result_timeout = result_timeout
        self._procs: Optional[list] = None
        self._in_q = self._out_q = None

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def _ensure_pool(self) -> None:
        if self._procs is not None:
            return
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._in_q = ctx.Queue()
        self._out_q = ctx.Queue()
        blob = pickle.dumps(self.dataset_cfg)
        self._procs = [
            ctx.Process(target=_worker_main,
                        args=(blob, self._in_q, self._out_q, w, self.seed),
                        daemon=True, name=f"vb-loader-{w}")
            for w in range(self.num_procs)]
        # the children start with the card hidden, before any import
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            for p in self._procs:
                p.start()
        finally:
            if saved is None:
                del os.environ["CUDA_VISIBLE_DEVICES"]
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved
        atexit.register(self.close)

    def close(self) -> None:
        if self._procs is None:
            return
        procs, self._procs = self._procs, None
        for _ in procs:
            try:
                self._in_q.put_nowait(None)
            except Exception:
                pass
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        for q in (self._in_q, self._out_q):
            try:
                q.close()
            except Exception:
                pass
        self._in_q = self._out_q = None

    def _next_result(self):
        """out_q.get that notices dead workers instead of hanging forever."""
        deadline = self.result_timeout
        while True:
            try:
                return self._out_q.get(timeout=min(deadline, 1.0))
            except queue_mod.Empty:
                dead = [p.name for p in self._procs if not p.is_alive()]
                if dead:
                    self.close()
                    raise RuntimeError(
                        f"loader worker(s) died without a result: {dead}")
                deadline -= 1.0
                if deadline <= 0:
                    self.close()
                    raise TimeoutError(
                        f"no loader batch within {self.result_timeout}s")

    def __iter__(self) -> Iterator[Any]:
        self._ensure_pool()
        # epoch tag in the sequence id: an abandoned iteration (a trainer that
        # stops at max_steps) leaves results in out_q; without the tag they
        # would collide with the next iteration's seq 0..N as stale batches
        self._epoch = getattr(self, "_epoch", 0) + 1
        epoch = self._epoch
        batches: List[List[int]] = [list(b) for b in self.batch_sampler]
        it = iter(batches)
        submitted = 0
        for _ in range(min(self.prefetch, len(batches))):
            self._in_q.put(((epoch, submitted), next(it)))
            submitted += 1
        buf = {}
        for next_seq in range(len(batches)):
            while next_seq not in buf:
                seq, ok, payload = self._next_result()
                if not ok:
                    self.close()
                    raise RuntimeError(f"loader worker failed:\n{payload}")
                if isinstance(seq, tuple) and seq[0] != epoch:
                    continue  # stale result from an abandoned iteration
                buf[seq[1] if isinstance(seq, tuple) else seq] = payload
            batch = buf.pop(next_seq)
            try:
                self._in_q.put(((epoch, submitted), next(it)))
                submitted += 1
            except StopIteration:
                pass
            yield batch
