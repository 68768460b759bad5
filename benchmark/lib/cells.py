"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell ``<name>`` is ``benchmark/workloads/<name>.json`` (its configuration,
traffic mix, driver, chips, why, and the limits of its correctness
comparison); its configuration is ``benchmark/configs/<config>.json``, its
traffic ``benchmark/traffic/<traffic>.json``, its driver
``benchmark/drivers/<driver>.py`` and each per-layer metric
``benchmark/metrics/<metric>.py``, or, where that file is missing, the reader
shared by the metrics of one stem (the name before its first dot:
``device_idle_pct.train`` is read by ``metrics/device_idle_pct.py``). A new
cell, configuration, mix or metric is a new file and a new entry, never an
edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from typing import Any, Dict

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _json(*parts: str) -> Dict[str, Any]:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    return _json(root, "BENCHMARK.json")


def cell(name: str) -> Dict[str, Any]:
    """The workload file merged with its configuration and traffic."""
    if not NAME.match(name):
        raise ValueError(f"not a cell name: {name!r}")
    w = _json(BENCH, "workloads", f"{name}.json")
    from benchmark.lib import traffic

    return {**w, "name": name, "config_data": _json(BENCH, "configs", f"{w['config']}.json"),
            "traffic_data": traffic.load(w["traffic"])}


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metric_file(name: str) -> str:
    """The reader of metric ``name``: its own file, else its stem's."""
    own = os.path.join(BENCH, "metrics", f"{name}.py")
    return own if os.path.exists(own) else \
        os.path.join(BENCH, "metrics", f"{name.split('.')[0]}.py")


def metric_reader(name: str):
    """The ``read`` of metric ``name``'s reader (``metric_file``)."""
    path = metric_file(name)
    stem = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_for(bench: Dict[str, Any], cell_name: str) -> list:
    """The per-layer metrics a traced run of ``cell_name`` reports."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if cells is None:
            moved = e2e[m["moves"]]
            cells = moved.get("workloads", [w["name"] for w in bench["workloads"]])
        if cell_name in cells:
            out.append(m)
    return out


def end_to_end_for(bench: Dict[str, Any], cell_name: str) -> list:
    return [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
