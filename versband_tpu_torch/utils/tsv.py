"""Quote-free TSV reading and writing without pandas (port of
``versband_tpu/utils/tsv.py``; its shell-style file helpers have no caller and
are not ported).

:func:`save_df_to_tsv` writes a :class:`~versband_tpu_torch.data.manifests.Manifest`
byte for byte as ``DataFrame.to_csv(sep="\\t", index=False, escapechar="\\\\",
quoting=csv.QUOTE_NONE)`` writes the same table: no quoting, tabs, quotes and
backslashes in a cell escaped with a backslash, NaN and None as an empty
cell, floats by ``repr``.
"""

from __future__ import annotations

import csv
import math
from typing import Any, Dict, List

from versband_tpu_torch.data.manifests import Manifest


def load_samples_from_tsv(path: str) -> List[Dict[str, str]]:
    with open(path, encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter="\t", quotechar=None, doublequote=False,
                                lineterminator="\n", quoting=csv.QUOTE_NONE)
        return [dict(row) for row in reader]


def load_dict_from_tsv(path: str, key: str) -> Dict[str, Dict[str, str]]:
    """The rows of ``path`` keyed by their ``key`` column (a later row wins)."""
    return {row[key]: row for row in load_samples_from_tsv(path)}


def _cell(v: Any) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return repr(v) if isinstance(v, float) else str(v)


def save_df_to_tsv(df: Manifest, path: str) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n", escapechar="\\",
                       quoting=csv.QUOTE_NONE)
        w.writerow(df.columns)
        for row in df.rows:
            w.writerow([_cell(row.get(c)) for c in df.columns])
