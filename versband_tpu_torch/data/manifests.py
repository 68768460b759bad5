"""TSV manifests without pandas (port of ``versband_tpu/data/manifests.py``).

A manifest directory holds ``*.tsv`` files, read in sorted order and
concatenated into one table. Cells come back with the values
``pandas.read_csv(sep="\\t")`` and ``pd.concat`` give them, for what the CLIs
read:

* an empty cell, or one of pandas' NA strings (``nan``, ``None``, ``NA``,
  ``null``, ...), is ``float('nan')``, so ``str()`` of an empty caption is
  ``'nan'``;
* a column whose cells are all integers is ``int`` (``float`` when one is
  missing); one whose cells all parse as numbers is ``float``; ``True`` /
  ``False`` columns are ``bool``; any other column keeps strings, NaN in its
  empty cells;
* across files a column takes the widest of its kinds (int < float <
  strings); in a string column each value keeps its own file's type, as in
  an ``object`` column.

:func:`split_dataset` splits a table as the datasets do: the first
``valid_head`` rows validate, the rest train, and the test split takes every
row with duplicate names suffixed (:func:`add_name_num`); each split's rows
are renumbered from 0 with the old position kept in an ``index`` column, as
``DataFrame.reset_index()`` does.

:func:`write_tsv` writes as ``DataFrame.to_csv(sep="\\t", index=False)``
does: ``csv`` quoting, NaN as an empty cell, floats by ``repr``.
"""

from __future__ import annotations

import csv
import glob
import math
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence

# pandas' default na_values (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_VALUES = frozenset(["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
                       "n/a", "nan", "null"])
_INT = re.compile(r"^[+-]?[0-9]+$")
_FLOAT = re.compile(r"^[+-]?(?:[0-9]+\.?[0-9]*(?:[eE][+-]?[0-9]+)?|\.[0-9]+(?:[eE][+-]?[0-9]+)?"
                    r"|inf|infinity)$", re.I)
_BOOL = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False,
         "false": False}
_KINDS = ("bool", "int", "float", "object")
NAN = float("nan")


def _column(cells: Sequence[str]):
    """(kind, values) of one column of one file, as pandas' parser infers it."""
    present = [c for c in cells if c not in NA_VALUES]
    missing = len(present) < len(cells)
    if present and all(_INT.match(c) for c in present):
        if missing:
            return "float", [NAN if c in NA_VALUES else float(int(c)) for c in cells]
        return "int", [int(c) for c in cells]
    if present and all(_FLOAT.match(c) for c in present):
        return "float", [NAN if c in NA_VALUES else float(c) for c in cells]
    if present and not missing and all(c in _BOOL for c in present):
        return "bool", [_BOOL[c] for c in cells]
    if not present:
        return "float", [NAN] * len(cells)  # an all-empty column is float64 NaN
    return "object", [NAN if c in NA_VALUES else c for c in cells]


class Manifest:
    """Rows of a manifest table: ``columns`` and one dict per row."""

    def __init__(self, columns: List[str], rows: List[Dict[str, Any]],
                 kinds: Optional[Dict[str, str]] = None):
        self.columns = columns
        self.rows = rows
        self.kinds = kinds or {c: "object" for c in columns}

    def __len__(self) -> int:
        return len(self.rows)

    def __contains__(self, column: str) -> bool:
        return column in self.columns

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return self.rows[i]

    def take(self, indices: Iterable[int]) -> "Manifest":
        return Manifest(self.columns, [self.rows[i] for i in indices], self.kinds)

    def where(self, keep: Iterable[bool]) -> "Manifest":
        return Manifest(self.columns, [r for r, k in zip(self.rows, keep) if k], self.kinds)


def read_tsv(path: str) -> Manifest:
    with open(path, newline="", encoding="utf-8") as f:
        table = list(csv.reader(f, delimiter="\t"))
    if not table:
        raise ValueError(f"{path}: no header")
    columns, body = table[0], [r for r in table[1:] if r]
    cols = {}
    for j, name in enumerate(columns):
        cols[name] = _column([r[j] if j < len(r) else "" for r in body])
    rows = [{name: cols[name][1][i] for name in columns} for i in range(len(body))]
    return Manifest(list(columns), rows, {name: cols[name][0] for name in columns})


def concat(parts: Sequence[Manifest]) -> Manifest:
    """``pd.concat(..., ignore_index=True)``: columns in order of first
    appearance, missing cells NaN, each column at the widest kind of its parts."""
    columns: List[str] = []
    for p in parts:
        columns += [c for c in p.columns if c not in columns]
    kinds = {}
    for c in columns:
        ks = {p.kinds[c] if c in p.columns else "float" for p in parts}
        if "object" in ks or ("bool" in ks and len(ks) > 1):
            kinds[c] = "object"
        else:
            kinds[c] = max(ks, key=_KINDS.index)
    rows = []
    for p in parts:
        for r in p.rows:
            row = {}
            for c in columns:
                v = r.get(c, NAN) if c in p.columns else NAN
                row[c] = float(v) if kinds[c] == "float" else v
            rows.append(row)
    return Manifest(columns, rows, kinds)


def load_manifest_dirs(dir_paths: str, recursive: bool = False) -> Manifest:
    """Every ``*.tsv`` under the comma-separated ``dir_paths``, in sorted order."""
    files: List[str] = []
    for dir_path in str(dir_paths).split(","):
        pattern = f"{dir_path}/**/*.tsv" if recursive else f"{dir_path}/*.tsv"
        files += glob.glob(pattern, recursive=recursive)
    if not files:
        raise FileNotFoundError(f"no .tsv manifests under {dir_paths!r}")
    return concat([read_tsv(f) for f in sorted(files)])


def _cell(v: Any) -> str:
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    return str(v)


def write_tsv(path: str, columns: Sequence[str], rows: Iterable[Dict[str, Any]]) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        w.writerow(columns)
        for r in rows:
            w.writerow([_cell(r[c]) for c in columns])


def split_dataset(df: Manifest, split: str, valid_head: int) -> Manifest:
    """train = rows[valid_head:], valid = rows[:valid_head], test = all with
    names made unique; an ``index`` column (first) holds each row's position
    in the split's source."""
    if split == "train":
        start, rows = valid_head, df.rows[valid_head:]
    elif split in ("valid", "val"):
        start, rows = 0, df.rows[:valid_head]
    elif split == "test":
        start, rows = 0, add_name_num(df).rows
    else:
        raise ValueError(f"Unknown split {split}")
    rows = [{"index": start + i, **r} for i, r in enumerate(rows)]
    columns = ["index"] + [c for c in df.columns if c != "index"]
    return Manifest(columns, rows, {"index": "int", **df.kinds})


def add_name_num(df: Manifest) -> Manifest:
    """A copy with each name suffixed ``_<n>``, n counting that name's earlier
    rows, so every audio-caption pair has a unique identifier."""
    counts: Dict[Any, int] = {}
    rows = []
    for r in df.rows:
        n = counts.get(r["name"], -1) + 1
        counts[r["name"]] = n
        rows.append({**r, "name": f"{r['name']}_{n}"})
    return Manifest(df.columns, rows, {**df.kinds, "name": "object"})


def argsort_column(df: Manifest, column: str) -> List[int]:
    """Row positions in ascending order of the numeric ``column``, NaN last:
    ``sort_values(by=column)``, whose default is numpy's unstable quicksort,
    over the column's dtype as pandas holds it, so ties come out in the same
    order."""
    import numpy as np

    dtype = np.int64 if df.kinds.get(column) == "int" else np.float64
    values = np.asarray([r[column] for r in df.rows], dtype=dtype)
    nan = np.isnan(values)
    idx = np.arange(len(values))
    order = idx[~nan][values[~nan].argsort(kind="quicksort")]
    return [int(i) for i in np.concatenate([order, idx[nan]])]
