"""The port's data layer against ``versband_tpu.data`` (CPU, numpy only).

On a synthetic manifest written from a seed (``write_v2a_manifest``: ragged
mel lengths that tie on duration, a vocal mel that trips the length guard,
and a NaN duration where the test says so) both packages give:

* the same ``split_dataset`` tables and ``ordered_indices`` (pandas'
  unstable quicksort order on ties);
* bit-equal items and ``collater`` batches, with equal captions and names,
  for each split, with CFG dropout on, from the same dataset seed;
* the same ``IndexBatchSampler`` batches over two shuffled epochs, with rank
  striding, ``drop_last`` and ``max_tokens``;
* the same batches from ``SpectrogramDataModule`` built from the shipped
  YAML's ``data:`` section (its dataset seed, which the YAML leaves unset,
  fixed on both sides);
* every collate and pad helper on the cases of tests/test_data_layer.py.

``ProcessDataLoader`` (spawned workers) delivers the single-process order,
raises a worker's failure, and drops an abandoned iteration's batches.
"""

import os
import time

import numpy as np
import pytest

from versband_tpu.data import collate as jcollate
from versband_tpu.data import datamodule as jdm
from versband_tpu.data import manifests as jman
from versband_tpu.data import sampler as jsampler
from versband_tpu.data import vocal2accomp as jv2a
from versband_tpu.utils.config import load_config as j_load_config
from versband_tpu_torch.data import collate as pcollate
from versband_tpu_torch.data import datamodule as pdm
from versband_tpu_torch.data import manifests as pman
from versband_tpu_torch.data import sampler as psampler
from versband_tpu_torch.data import vocal2accomp as pv2a
from versband_tpu_torch.data.proc_loader import ProcessDataLoader
from versband_tpu_torch.data.rng import ThreadLocalRNG
from versband_tpu_torch.utils.config import apply_dot_overrides, instantiate_from_config
from torch_port_helpers import write_v2a_manifest

LENGTHS, EXTRA = (40, 52, 60, 33), (0, 3, 9, 2)


def _assert_same(a, b, where=""):
    """Nested batches equal: arrays bit for bit (and dtype), the rest ==."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("v2a")
    manifest, midi = write_v2a_manifest(root, 316, LENGTHS, seed=1, vocal_extra=EXTRA)
    return dict(root=root, manifest=manifest, midi=midi)


def test_manifest_split_and_order_match_jax(tmp_path):
    import pandas as pd

    rng = np.random.default_rng(0)
    rows = [dict(name=f"s{i % 7}", duration=float(rng.integers(0, 4)), n=i) for i in range(40)]
    rows[3]["duration"] = float("nan")
    pd.DataFrame(rows).to_csv(tmp_path / "a.tsv", sep="\t", index=False)
    jdf, pdf = jman.load_manifest_dirs(str(tmp_path)), pman.load_manifest_dirs(str(tmp_path))
    for split in ("train", "valid", "test"):
        a, b = jman.split_dataset(jdf, split, 10), pman.split_dataset(pdf, split, 10)
        assert list(a.columns) == b.columns
        for x, y in zip(a.to_dict("records"), b.rows):
            assert {k: v for k, v in x.items() if v == v} == {k: v for k, v in y.items()
                                                              if v == v}
        assert list(a[["duration"]].sort_values(by="duration").index) \
            == pman.argsort_column(b, "duration")
    with pytest.raises(ValueError):
        pman.split_dataset(pdf, "nope", 10)


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_items_and_batches_match_jax(tree, split):
    cfg = dict(main_spec_dir_path=tree["manifest"], other_condition=tree["midi"],
               spec_crop_len=48, min_batch_len=16, drop=0.3, seed=5)
    a, b = jv2a.JoinManifestSpecs(split, **cfg), pv2a.JoinManifestSpecs(split, **cfg)
    assert len(a) == len(b) == (16 if split == "train" else 300 if split == "valid" else 316)
    assert a.ordered_indices() == b.ordered_indices()
    items_a = [a[i] for i in range(min(len(a), 40))]
    items_b = [b[i] for i in range(min(len(b), 40))]
    for x, y in zip(items_a, items_b):
        _assert_same(x, y, split)
    for k in range(0, len(items_a), 8):
        _assert_same(a.collater(items_a[k:k + 8]), b.collater(items_b[k:k + 8]), split)


def test_thread_local_rng_first_use_order():
    import threading

    rng = ThreadLocalRNG(9)
    first = rng.integers(1 << 30, size=3)
    got = []
    t = threading.Thread(target=lambda: got.append(rng.integers(1 << 30, size=3)))
    t.start()
    t.join()
    np.testing.assert_array_equal(first, np.random.default_rng([9, 0]).integers(1 << 30, size=3))
    np.testing.assert_array_equal(got[0], np.random.default_rng([9, 1]).integers(1 << 30, size=3))
    assert ThreadLocalRNG(None)._seed != ThreadLocalRNG(None)._seed


SAMPLER_CASES = [
    dict(indices=list(range(20)), batch_size=2, num_replicas=2, rank=1, shuffle=False),
    dict(indices=list(range(23)), batch_size=4, num_replicas=3, rank=2, shuffle=True, seed=4),
    dict(indices=list(range(8)), batch_size=2, num_replicas=4, rank=3, shuffle=False),
    dict(indices=[0, 1], batch_size=2, num_replicas=4, rank=2, shuffle=False),
    dict(indices=[], batch_size=2, num_replicas=4, rank=0),
    dict(indices=[0, 1, 2], batch_size=2, num_replicas=4, rank=1, drop_last=True),
    dict(indices=list(range(10)), batch_size=8, num_replicas=1, rank=0, shuffle=False,
         max_tokens=350, lengths=[100] * 10),
    dict(indices=list(range(31))[::-1], batch_size=5, num_replicas=2, rank=0, shuffle=True,
         seed=1, max_tokens=400, lengths=[10 * (i % 9) + 5 for i in range(31)]),
]


@pytest.mark.parametrize("case", range(len(SAMPLER_CASES)))
def test_sampler_matches_jax_over_two_epochs(case):
    kw = SAMPLER_CASES[case]
    a, b = jsampler.IndexBatchSampler(**kw), psampler.IndexBatchSampler(**kw)
    for epoch in (0, 1):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        assert list(a) == list(b) and len(a) == len(b)


def test_sampler_replicas_default_to_one():
    s = psampler.IndexBatchSampler(list(range(6)), 2, shuffle=False)
    assert (s.num_replicas, s.rank) == (1, 0) and list(s) == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError):
        psampler.IndexBatchSampler([0], 1, num_replicas=2, rank=2)


def test_spectrogram_datamodule_from_the_shipped_yaml(tree, monkeypatch):
    """The YAML's data section with the paths overridden; the YAML passes no
    dataset seed (fresh entropy per run), fixed here on both sides."""
    from versband_tpu_torch.utils.config import load_config

    over = [f"data.params.main_spec_dir_path={tree['manifest']}",
            f"data.params.other_condition={tree['midi']}", "data.params.num_workers=0",
            "data.params.spec_crop_len=48", "data.params.min_batch_len=16"]
    for mod in (jv2a, pv2a):
        real = mod.ThreadLocalRNG
        monkeypatch.setattr(mod, "ThreadLocalRNG",
                            lambda seed=None, real=real: real(3 if seed is None else seed))
    from versband_tpu.utils.config import apply_dot_overrides as j_over
    from versband_tpu.utils.config import instantiate_from_config as j_inst

    jcfg = j_over(j_load_config("configs/vocal2music.yaml"), over)["data"]
    pcfg = apply_dot_overrides(load_config("configs/vocal2music.yaml"), over)["data"]
    assert jcfg == pcfg
    jmod, pmod = j_inst(jcfg).setup(), instantiate_from_config(pcfg).setup()
    assert isinstance(pmod, pdm.SpectrogramDataModule) and set(pmod.datasets) == {
        "train", "validation"}
    assert pmod.dataset_configs["train"]["params"]["specs_dataset_cfg"] == \
        jmod.dataset_configs["train"]["params"]["specs_dataset_cfg"]
    for name in ("train_dataloader", "val_dataloader"):
        la, lb = getattr(jmod, name)(), getattr(pmod, name)()
        la.prefetch = lb.prefetch = 1  # one batch thread: items draw in batch order
        assert len(la) == len(lb) > 0
        for k, (x, y) in enumerate(zip(la, lb)):
            _assert_same(x, y, f"{name}[{k}]")
            if k == 5:
                break
    with pytest.raises(KeyError):
        pmod.test_dataloader()


def test_collate_helpers_match_jax():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for length, dim, pad in ((6, 1, -5), (2, 1, 0), (4, 1, 0), (5, 0, 7)):
        _assert_same(jcollate.pad_or_cut_xd(x, length, dim, pad),
                     pcollate.pad_or_cut_xd(x, length, dim, pad))
    two = [np.ones((80, 10)), np.arange(80 * 13, dtype=np.float64).reshape(80, 13)]
    one = [np.array([1.0, 2, 3]), np.array([4.0, 5])]
    cases = [("collate_2d", two, dict(pad_idx=-5, min_factor=4)),
             ("collate_2d", two, dict(pad_idx=0, min_len=32, min_factor=4)),
             ("collate_2d", two, dict(pad_idx=0, max_len=8, min_factor=4)),
             ("collate_2d", two, dict(left_pad=True, min_factor=5)),
             ("collate_1d", one, dict(pad_idx=0, shift_right=True, shift_id=9)),
             ("collate_1d", one, dict(left_pad=True, min_len=6)),
             ("collate_1d_or_2d", one, dict(pad_idx=3)),
             ("collate_1d_or_2d", two, dict(pad_idx=3, max_len=11)),
             ("collate_2d_tile", [np.ones((4, 3)) * 7, np.ones((4, 8))], dict(min_factor=4)),
             ("collate_1d_tile", one, dict(shift_right=True, min_len=7)),
             ("collate_1d_or_2d_tile", one, dict(max_len=2)),
             ("collate_1d_or_2d_tile", two, dict(min_factor=8))]
    for name, vals, kw in cases:
        _assert_same(getattr(jcollate, name)(vals, **kw), getattr(pcollate, name)(vals, **kw),
                     name)
    assert pcollate.collate_2d_tile([np.ones((4, 3)) * 7, np.ones((4, 8))],
                                    min_factor=4)[0].tolist() == [[7.0] * 8] * 4


def test_threaded_loader_matches_jax(tree):
    cfg = dict(main_spec_dir_path=tree["manifest"], other_condition=tree["midi"],
               spec_crop_len=48, min_batch_len=16, drop=0.3, seed=8)
    outs = []
    for v2a, sam, dm in ((jv2a, jsampler, jdm), (pv2a, psampler, pdm)):
        ds = v2a.JoinSpecsTrain(cfg)
        s = sam.IndexBatchSampler(ds.ordered_indices(), 4, num_replicas=1, rank=0, seed=2)
        loader = dm.DataLoader(ds, s, num_workers=1, prefetch=1)
        epochs = []
        for epoch in (0, 1):
            s.set_epoch(epoch)
            epochs.append(list(loader))
        outs.append(epochs)
    for ea, eb in zip(*outs):
        assert len(ea) == len(eb) == 4
        for x, y in zip(ea, eb):
            _assert_same(x, y)


def _proc_cfg(tree):
    """A dataset with no randomness in its arrays: no crop (every mel fits
    the crop length), no dropout."""
    return {"target": "versband_tpu_torch.data.vocal2accomp.JoinManifestSpecs",
            "params": {"split": "test", "main_spec_dir_path": tree["manifest"],
                       "other_condition": tree["midi"], "spec_crop_len": 80,
                       "min_batch_len": 16, "drop": 0.0, "seed": 0}}


def _arrays(batch):
    return {k: batch[k] for k in ("image", "acoustic", "midi", "beats", "name")}


def test_proc_loader_matches_sequential_order(tree):
    cfg = _proc_cfg(tree)
    ds = instantiate_from_config(cfg)
    sampler = psampler.IndexBatchSampler(list(range(24)), 3, num_replicas=1, rank=0,
                                         shuffle=False)
    want = [_arrays(ds.collater([ds[i] for i in idxs])) for idxs in sampler]
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    loader = ProcessDataLoader(cfg, sampler, num_procs=2, seed=0)
    try:
        got = list(loader)
        assert len(got) == len(want) == len(loader)
        for g, w in zip(got, want):
            _assert_same(_arrays(g), w)
        pids = [p.pid for p in loader._procs]
        again = list(loader)  # the pool persists across epochs
        assert [p.pid for p in loader._procs] == pids and len(again) == len(want)
        # the card is hidden from the children only
        assert os.environ.get("CUDA_VISIBLE_DEVICES") == env
    finally:
        loader.close()


def test_proc_loader_worker_failure_propagates(tree):
    bad = {"target": "versband_tpu_torch.data.vocal2accomp.NoSuchDataset", "params": {}}
    sampler = psampler.IndexBatchSampler(list(range(4)), 2, num_replicas=1, rank=0,
                                         shuffle=False)
    loader = ProcessDataLoader(bad, sampler, num_procs=1, seed=0, result_timeout=60)
    with pytest.raises(RuntimeError, match="NoSuchDataset"):
        list(loader)
    assert loader._procs is None  # the pool is torn down


def test_proc_loader_drops_an_abandoned_iterations_batches(tree):
    cfg = _proc_cfg(tree)
    ds = instantiate_from_config(cfg)
    sampler = psampler.IndexBatchSampler(list(range(16)), 2, num_replicas=1, rank=0,
                                         shuffle=False)
    want = [_arrays(ds.collater([ds[i] for i in idxs])) for idxs in sampler]
    loader = ProcessDataLoader(cfg, sampler, num_procs=2, seed=0, prefetch=4)
    try:
        it = iter(loader)
        next(it)  # one batch consumed, three still in flight
        del it
        time.sleep(1.0)  # let the stale results land
        got = list(loader)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(_arrays(g), w)
    finally:
        loader.close()


def test_datamodule_uses_worker_processes(tree):
    mod = pdm.DataModule(4, train=_proc_cfg(tree), num_worker_procs=2, shuffle=False)
    loader = mod.train_dataloader()
    try:
        assert isinstance(loader, ProcessDataLoader)
        first = next(iter(loader))
        ds = mod.datasets["train"]
        _assert_same(_arrays(first), _arrays(ds.collater([ds[i] for i in
                                                           ds.ordered_indices()[:4]])))
    finally:
        loader.close()
