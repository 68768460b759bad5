"""Stage 1's data and item 8's last datasets in the port against
``versband_tpu`` (CPU, numpy): the C++ mel batch loader against its numpy
version (the cases of tests/test_native_loader.py), ``fixed_len`` items and
batches, ``anylen`` and ``tsvdataset`` items, collates and
``ordered_indices``, and ``save_df_to_tsv``'s bytes against pandas'.

Every comparison is exact (the same float32 values, the same strings): both
packages read the same files and draw from ``default_rng([seed, 0])`` (one
thread, the first to draw).
"""

import threading

import numpy as np
import pandas as pd
import pytest

from versband_tpu import native as jnative
from versband_tpu.data import anylen as janylen
from versband_tpu.data import fixed_len as jfixed
from versband_tpu.data import tsvdataset as jtsv
from versband_tpu.utils import tsv as jtsvutil
from versband_tpu_torch import native
from versband_tpu_torch.data import anylen, fixed_len, tsvdataset
from versband_tpu_torch.data.manifests import read_tsv
from versband_tpu_torch.utils import tsv as tsvutil
from torch_port_helpers import write_stage1_manifest

CROP = 40


@pytest.fixture(scope="module")
def mel_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mels")
    rng = np.random.RandomState(0)
    paths, arrays = [], []
    for i in range(16):
        arr = rng.randn(80, 40 + 7 * i).astype(np.float32)
        p = str(d / f"m{i}.npy")
        np.save(p, arr)
        paths.append(p)
        arrays.append(arr)
    return paths, arrays


def test_the_loader_builds_into_build():
    lib = native.ensure_built()
    path = native.library_path()
    assert path.exists() and path.parent.parent.parent.name == "versband_tpu_torch"
    assert path.parents[3].name == "build" and lib is native.ensure_built()


@pytest.mark.parametrize("t_target,starts", [(96, None), (16, 5), (200, 3), (1, None)])
def test_the_loader_equals_its_numpy_version(mel_files, t_target, starts):
    paths, arrays = mel_files
    st = None if starts is None else [starts] * len(paths)
    batch, lengths = native.load_mel_batch(paths, 80, t_target, pad_value=-5.0, starts=st)
    ref, ref_len = native.load_mel_batch_numpy(paths, 80, t_target, -5.0, st)
    np.testing.assert_array_equal(batch, ref)
    np.testing.assert_array_equal(lengths, ref_len)
    s = starts or 0
    n = lengths[3]
    np.testing.assert_array_equal(batch[3, :, :n], arrays[3][:, s: s + n])
    assert (batch[0, :, lengths[0]:] == -5.0).all()


def test_the_loader_matches_the_jax_packages(mel_files):
    paths, _ = mel_files
    got = native.load_mel_batch(paths, 80, 64, starts=list(range(len(paths))))
    want = jnative.load_mel_batch(paths, 80, 64, starts=list(range(len(paths))))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_a_bad_file_is_marked(tmp_path, mel_files):
    paths, _ = mel_files
    bad = str(tmp_path / "bad.npy")
    with open(bad, "w") as f:
        f.write("not an npy")
    for load in (native.load_mel_batch, native.load_mel_batch_numpy):
        batch, lengths = load([paths[0], bad, str(tmp_path / "missing.npy"), paths[1]], 80, 32)
        assert list(lengths[1:3]) == [-1, -1] and (batch[1:3] == -5.0).all()
        assert lengths[0] == lengths[3] == 32


def test_a_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="failed"):
        native.ensure_built()
    assert not list((tmp_path / "build").rglob("*.tmp"))


def test_concurrent_first_use_builds_once(tmp_path, monkeypatch):
    """Eight threads reach the unbuilt loader together: one library, no
    temporary file left, every thread gets the same handle."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    got, errors = [], []

    def use():
        try:
            got.append(native.ensure_built())
        except Exception as e:  # recorded for the assertion below
            errors.append(e)

    threads = [threading.Thread(target=use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(g is got[0] for g in got)
    assert [p.name for p in (tmp_path / "build").rglob("*") if p.is_file()] == ["libvbloader.so"]


def _equal_items(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_fixed_len_items_equal_jax(tmp_path, split):
    manifest = write_stage1_manifest(tmp_path, 130)
    cfg = dict(spec_dir_path=manifest, spec_crop_len=CROP, mel_num=80, seed=5, spec_len=CROP)
    cls = {"train": "JoinSpecsTrain", "valid": "JoinSpecsValidation", "test": "JoinSpecsTest"}[split]
    port, ref = getattr(fixed_len, cls)(cfg), getattr(jfixed, cls)(cfg)
    assert len(port) == len(ref) == {"train": 30, "valid": 100, "test": 130}[split]
    for i in range(len(port)):
        _equal_items(port[i], ref[i])
    # the tile, crop and corrupted-file paths all ran
    shapes = {port.dataset[i]["mel_path"].rsplit("/", 1)[1] for i in range(len(port))}
    assert {"mel0.npy", "mel3.npy", "corrupt.npy"} <= shapes


@pytest.mark.parametrize("split", ["train", "test"])
def test_fixed_len_batches_equal_jax(tmp_path, split):
    manifest = write_stage1_manifest(tmp_path, 130)
    cfg = dict(spec_dir_path=manifest, spec_crop_len=CROP, mel_num=80, seed=9)
    cls = "JoinSpecsTrain" if split == "train" else "JoinSpecsTest"
    port, ref = getattr(fixed_len, cls)(cfg), getattr(jfixed, cls)(cfg)
    for idxs in ([0, 1, 2, 3, 4], [9, 3, 7], list(range(10, 30))):
        got, want = port.load_batch(np.asarray(idxs)), ref.load_batch(np.asarray(idxs))
        _equal_items(got, want)
        assert got["image"].shape == (len(idxs), 80, CROP)
    zero = [i for i in range(len(port)) if port.dataset[i]["mel_path"].endswith("corrupt.npy")]
    assert (port.load_batch(zero[:2])["image"] == 0).all()
    _equal_items(port.collater([port[0], port[1]]), ref.collater([ref[0], ref[1]]))


@pytest.mark.parametrize("mode", ["pad", "tile"])
@pytest.mark.parametrize("split", ["train", "valid", "test"])
@pytest.mark.parametrize("other", [False, True], ids=["main", "main_other"])
def test_anylen_equals_jax(tmp_path, mode, split, other):
    main = write_stage1_manifest(tmp_path / "main", 140, nested=False)
    other_dir = write_stage1_manifest(tmp_path / "other", 12, lengths=(33, 90),
                                      corrupt=False, nested=False) if other else ""
    cfg = dict(main_spec_dir_path=main, other_spec_dir_path=other_dir, mode=mode,
               spec_crop_len=64, drop=0.3, seed=4, pad_value=-5.0)
    cls = {"train": "JoinSpecsTrain", "valid": "JoinSpecsValidation", "test": "JoinSpecsTest"}[split]
    port, ref = getattr(anylen, cls)(cfg), getattr(janylen, cls)(cfg)
    assert len(port) == len(ref)
    po, ro = port.ordered_indices(), ref.ordered_indices()
    if other:
        assert [list(x) for x in po] == [list(x) for x in ro]
    else:
        assert list(po) == list(ro)
    items_p = [port[i] for i in range(len(port))]
    items_r = [ref[i] for i in range(len(ref))]
    for a, b in zip(items_p, items_r):
        _equal_items(a, b)
    assert {"", "nan"} <= {i["caption"] for i in items_p}  # dropped, and an empty cell
    for lo in range(0, len(port) - 5, 5):
        _equal_items(port.collater(items_p[lo: lo + 5]), ref.collater(items_r[lo: lo + 5]))


def test_struct_anylen_equals_jax(tmp_path):
    main = write_stage1_manifest(tmp_path / "main", 120, nested=False)
    other_dir = write_stage1_manifest(tmp_path / "other", 6, lengths=(33,), corrupt=False,
                                      nested=False)
    cfg = dict(main_spec_dir_path=main, other_spec_dir_path=other_dir, spec_crop_len=64,
               drop=0.25, seed=2)
    port = anylen.StructJoinManifestSpecs("train", **cfg)
    ref = janylen.StructJoinManifestSpecs("train", **cfg)
    items_p = [port[i] for i in range(len(port))]
    items_r = [ref[i] for i in range(len(ref))]
    for a, b in zip(items_p, items_r):
        assert a["caption"] == b["caption"] and a["name"] == b["name"]
        np.testing.assert_array_equal(a["image"], b["image"])
    assert any(i["caption"]["struct_caption"].endswith("& all>") for i in items_p)
    got, want = port.collater(items_p[:4]), ref.collater(items_r[:4])
    assert got["caption"] == want["caption"]
    np.testing.assert_array_equal(got["image"], want["image"])


@pytest.mark.parametrize("struct", [False, True])
def test_tsvdataset_equals_jax(tmp_path, struct):
    rng = np.random.default_rng(3)
    rows = []
    for i, T in enumerate((20, 45, 90)):
        p = tmp_path / f"m{i}.npy"
        np.save(p, rng.standard_normal((80, T)).astype(np.float32))
        rows.append(dict(name=f"n{i}", mel_path=str(p), caption=f"c{i}",
                         ori_cap=("" if i == 1 else f"o{i}")))
    rows.append(dict(name="gone", mel_path=str(tmp_path / "missing.npy"), caption="",
                     ori_cap="x"))
    path = tmp_path / "t.tsv"
    pd.DataFrame(rows).to_csv(path, sep="\t", index=False)
    cls = "TSVDatasetStruct" if struct else "TSVDataset"
    port = getattr(tsvdataset, cls)(str(path), spec_crop_len=40, seed=8)
    ref = getattr(jtsv, cls)(str(path), spec_crop_len=40, seed=8)
    assert len(port) == len(ref) == 4
    for i in range(4):
        _equal_items(port[i], ref[i])


def test_save_df_to_tsv_bytes_equal_pandas(tmp_path):
    rows = [dict(name="a", n=1, x=0.1, cap="tab\there", q='say "hi"', b=True),
            dict(name="b\\c", n=2, x=float("nan"), cap="", q="plain", b=False),
            dict(name="d", n=3, x=1e20, cap="semi;colon", q="x'y", b=True)]
    df = pd.DataFrame(rows)
    jtsvutil.save_df_to_tsv(df, str(tmp_path / "pandas.tsv"))
    manifest_path = tmp_path / "pandas_read.tsv"
    df.to_csv(manifest_path, sep="\t", index=False)
    tsvutil.save_df_to_tsv(read_tsv(str(manifest_path)), str(tmp_path / "port.tsv"))
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "pandas.tsv").read_bytes()
    assert tsvutil.load_samples_from_tsv(str(tmp_path / "port.tsv")) == \
        jtsvutil.load_samples_from_tsv(str(tmp_path / "pandas.tsv"))
