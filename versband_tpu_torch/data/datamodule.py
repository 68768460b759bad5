"""Host data pipeline: datasets, a threaded prefetching loader and numpy
batches (port of ``versband_tpu/data/datamodule.py``).

:class:`DataLoader` maps ``dataset[i]`` over a pool of item threads (numpy
IO releases the GIL) while a pool of batch threads keeps ``prefetch`` batches
in flight; the batch sampler is :class:`IndexBatchSampler` and the collate is
the dataset's own ``collater``. Batches are numpy trees; the trainer moves
them to the card. While spans are on (``utils/profiling.py``) the loader
counts the batches it yields (``data.loader.batches``) and those not ready
when asked for (``data.loader.waited``).
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional

from versband_tpu_torch.data.sampler import IndexBatchSampler
from versband_tpu_torch.utils.config import instantiate_from_config
from versband_tpu_torch.utils.profiling import count


class DataLoader:
    """Iterable over collated batches with background prefetch.

    ``batch_sampler`` yields index lists; ``num_workers`` threads map
    ``dataset[i]``; ``prefetch`` batches are kept in flight.
    """

    def __init__(self, dataset, batch_sampler, collate_fn: Optional[Callable] = None,
                 num_workers: int = 8, prefetch: int = 2):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn or getattr(dataset, "collater", None) \
            or (lambda items: items)
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def __iter__(self) -> Iterator[Any]:
        batches = list(self.batch_sampler)
        # Two pools: batch futures run on batch_pool and map items onto
        # item_pool — a single shared pool would self-deadlock (a batch task
        # waiting on item tasks that can never be scheduled).
        with ThreadPoolExecutor(self.num_workers) as item_pool, \
                ThreadPoolExecutor(self.prefetch) as batch_pool:
            batch_loader = getattr(self.dataset, "load_batch", None)

            def fetch(idx_list):
                if batch_loader is not None:
                    return batch_loader(idx_list)
                items = list(item_pool.map(self.dataset.__getitem__, idx_list))
                return self.collate_fn(items)

            pending: "queue.Queue" = queue.Queue()
            it = iter(batches)
            # prime the pipeline
            for _ in range(self.prefetch):
                try:
                    pending.put(batch_pool.submit(fetch, next(it)))
                except StopIteration:
                    break
            while not pending.empty():
                fut = pending.get()
                try:
                    pending.put(batch_pool.submit(fetch, next(it)))
                except StopIteration:
                    pass
                count("data.loader.batches")
                if not fut.done():
                    count("data.loader.waited")
                yield fut.result()


def _ordered_or_range(dataset) -> List[int]:
    if hasattr(dataset, "ordered_indices"):
        idx = dataset.ordered_indices()
        if isinstance(idx, tuple):  # (main, other) pools -> concatenated
            return list(idx[0]) + list(idx[1])
        return list(idx)
    return list(range(len(dataset)))


class DataModule:
    """Builds train/val/test loaders from dataset configs: the bucketed
    sampler over ``ordered_indices`` where a dataset has them, plain batching
    otherwise. ``num_worker_procs > 0`` assembles batches in that many
    worker processes (:class:`ProcessDataLoader`) instead of threads."""

    def __init__(self, batch_size: int, train=None, validation=None, test=None,
                 num_workers: Optional[int] = None, shuffle: bool = True,
                 num_replicas: Optional[int] = None, rank: Optional[int] = None,
                 seed: int = 0, num_worker_procs: int = 0, **kwargs):
        self.batch_size = batch_size
        self.num_workers = num_workers if num_workers is not None else batch_size * 2
        self.num_worker_procs = int(num_worker_procs)
        self.shuffle = shuffle
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.dataset_configs: Dict[str, Any] = {}
        for name, cfg in (("train", train), ("validation", validation),
                          ("test", test)):
            if cfg is not None:
                self.dataset_configs[name] = cfg
        self.datasets: Dict[str, Any] = {}

    def setup(self):
        for name, cfg in self.dataset_configs.items():
            if name not in self.datasets:
                self.datasets[name] = instantiate_from_config(cfg)
        return self

    def _loader(self, name: str, shuffle: bool) -> DataLoader:
        self.setup()
        ds = self.datasets[name]
        sampler = IndexBatchSampler(
            _ordered_or_range(ds), self.batch_size,
            num_replicas=self.num_replicas, rank=self.rank,
            shuffle=shuffle, seed=self.seed)
        if self.num_worker_procs > 0:
            # workers rebuild the dataset from its config; the parent's copy
            # only serves the sampler above
            from versband_tpu_torch.data.proc_loader import ProcessDataLoader

            return ProcessDataLoader(self.dataset_configs[name], sampler,
                                     num_procs=self.num_worker_procs,
                                     seed=self.seed)
        return DataLoader(ds, sampler, num_workers=self.num_workers)

    def train_dataloader(self) -> DataLoader:
        return self._loader("train", self.shuffle)

    def val_dataloader(self) -> DataLoader:
        return self._loader("validation", False)

    def test_dataloader(self) -> DataLoader:
        return self._loader("test", False)


class SpectrogramDataModule(DataModule):
    """Injects the shared ``specs_dataset_cfg`` (the data parameters of the
    YAML's ``data.params``) into each split's dataset config."""

    def __init__(self, batch_size: int, num_workers: Optional[int] = None,
                 spec_dir_path=None, mel_num=None, spec_len=None,
                 spec_crop_len=None, drop=None, pad_value=None, mode=None,
                 main_spec_dir_path=None, other_spec_dir_path=None,
                 other_condition=None, max_tokens=None, min_batch_len=None,
                 train=None, validation=None, test=None, **kwargs):
        specs_cfg = {k: v for k, v in dict(
            spec_dir_path=spec_dir_path, mel_num=mel_num, spec_len=spec_len,
            spec_crop_len=spec_crop_len, drop=drop, pad_value=pad_value,
            mode=mode, main_spec_dir_path=main_spec_dir_path,
            other_spec_dir_path=other_spec_dir_path,
            other_condition=other_condition, max_tokens=max_tokens,
            min_batch_len=min_batch_len,
        ).items() if v is not None}
        for split_cfg in (train, validation, test):
            if split_cfg is not None:
                split_cfg.setdefault("params", {})
                split_cfg["params"]["specs_dataset_cfg"] = specs_cfg
        super().__init__(batch_size, train=train, validation=validation,
                         test=test, num_workers=num_workers, **kwargs)
