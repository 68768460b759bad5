"""Length-bucketed batch sampling (port of ``versband_tpu/data/sampler.py``).

Duration-sorted indices are chunked into batches, the batches are
rank-strided across replicas (``batches[rank::num_replicas]``, wrapped so
every rank gets the same count), and shuffled per epoch from
``default_rng(seed + epoch)``. Replicas and rank come from
``torch.distributed`` when a process group is initialised, else 1 and 0.
``max_tokens``, when set, also caps a batch so that its size times its
longest item stays under it.
"""

from __future__ import annotations

import sys
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def _distributed_world() -> Tuple[int, int]:
    """(world size, rank) of an initialised ``torch.distributed`` group, else
    (1, 0). Looked up without importing torch: a process that never imported
    it cannot have initialised a group (the loader's workers import none)."""
    torch = sys.modules.get("torch")
    dist = getattr(torch, "distributed", None)
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class IndexBatchSampler:
    def __init__(self, indices: Sequence[int], batch_size: int,
                 num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False,
                 max_tokens: Optional[int] = None,
                 lengths: Optional[Sequence[int]] = None) -> None:
        if num_replicas is None or rank is None:
            world, me = _distributed_world()
            num_replicas = num_replicas or world
            rank = rank if rank is not None else me
        if not (0 <= rank < num_replicas):
            raise ValueError(f"invalid rank {rank} for {num_replicas} replicas")
        self.indices = list(indices)
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.drop_last = drop_last
        self.seed = seed
        self.shuffle = shuffle
        self.max_tokens = max_tokens
        self.lengths = None if lengths is None else list(lengths)
        self.epoch = 0

        batches = self._build_batches()
        if drop_last and len(batches) % num_replicas:
            batches = batches[: len(batches) // num_replicas * num_replicas]
        elif len(batches) % num_replicas and len(batches) >= num_replicas:
            # equalize per-rank batch counts by wrapping around (the torch
            # DistributedSampler padding semantics): unequal counts would
            # hang multihost collectives when the shorter ranks run dry
            batches = batches + batches[: (-len(batches)) % num_replicas]
        if len(batches) >= num_replicas:
            batches = batches[rank::num_replicas]
        elif batches:
            # Fewer batches than replicas (sanity-check epochs): wrap around so
            # every rank still sees exactly one batch and collectives stay in
            # lockstep; ranks beyond len(batches) reuse earlier batches.
            batches = [batches[rank % len(batches)]]
        # else: empty dataset/epoch → zero batches on every rank.
        self._all_batches = batches
        self.batches = self._shuffled(batches)

    def _build_batches(self) -> List[List[int]]:
        batches, batch, cur_max = [], [], 0
        for idx in self.indices:
            item_len = self.lengths[idx] if self.lengths is not None else 0
            cur_max = max(cur_max, item_len)
            over_tokens = (self.max_tokens is not None and batch
                           and (len(batch) + 1) * cur_max > self.max_tokens)
            if over_tokens:
                batches.append(batch)
                batch, cur_max = [], item_len
            batch.append(idx)
            if len(batch) == self.batch_size:
                batches.append(batch)
                batch, cur_max = [], 0
        if batch and not self.drop_last:
            batches.append(batch)
        return batches

    def _shuffled(self, batches: List[List[int]]) -> List[List[int]]:
        if not self.shuffle:
            return list(batches)
        rng = np.random.default_rng(self.seed + self.epoch)
        order = rng.permutation(len(batches))
        return [batches[i] for i in order]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.batches = self._shuffled(self._all_batches)

    def __iter__(self) -> Iterator[List[int]]:
        yield from self.batches

    def __len__(self) -> int:
        return len(self.batches)
