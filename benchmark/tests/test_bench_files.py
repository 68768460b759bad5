"""Every file the harness finds by name loads, and its names and units keep
to the allowed characters."""

import glob
import json
import os

import pytest

from benchmark.lib import cells, traffic

BENCH = cells.BENCH


def _stems(folder, ext):
    return sorted(os.path.basename(p)[: -len(ext)]
                  for p in glob.glob(os.path.join(BENCH, folder, f"*{ext}")))


def test_benchmark_json_names_and_units():
    b = cells.benchmark()
    assert b["paths"] == ["benchmark"] and b["command"][1] == "benchmark/run.py"
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names)), group
        for n in names:
            assert cells.NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert cells.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


@pytest.mark.parametrize("name", _stems("workloads", ".json"))
def test_workload_loads(name):
    b = cells.benchmark()
    c = cells.cell(name)
    entry = {w["name"]: w for w in b["workloads"]}[name]
    assert (entry["config"], entry["traffic"], entry["chips"]) == \
        (c["config"], c["traffic"], c["chips"])
    assert entry["why"] == c["why"] and len(c["why"]) <= 200
    assert cells.driver(c["driver"]).run
    assert cells.per_layer_for(b, name) and cells.end_to_end_for(b, name)
    assert c["limits"] and all(v >= 0 for v in c["limits"].values())


@pytest.mark.parametrize("name", _stems("configs", ".json"))
def test_config_loads(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        c = json.load(f)
    assert c["name"] == name and cells.NAME.match(name)
    assert {"source", "reduced", "assumed", "model"} <= set(c)
    assert {"mfu_peak_flops", "mfu_peak_flops_train"} & set(c)


def _mixes(generator):
    return [n for n in _stems("traffic", ".json")
            if n != "reference_templates" and traffic.load(n)["generator"] == generator]


@pytest.mark.parametrize("name", _mixes("clips"))
def test_clip_traffic_loads_and_repeats(name):
    mix = traffic.load(name)
    a, b = traffic.Clips(mix, 2 ** 31 + 11), traffic.Clips(mix, 2 ** 31 + 11)
    r, s = a[5], b[5]
    assert r["caption"] == s["caption"] and (r["midi"] == s["midi"]).all()
    assert r["midi"].shape == (1, traffic.frames(mix)) and "[" not in r["caption"]
    assert traffic.Clips(mix, 7)[5]["caption"] != r["caption"] or \
        (traffic.Clips(mix, 7)[5]["midi"] != r["midi"]).any()


@pytest.mark.parametrize("name", _stems("metrics", ".py"))
def test_metric_reader_loads_and_reads_nothing_from_nothing(name):
    assert cells.NAME.match(name)
    read = cells.metric_reader(name)
    empty = {"spans": {}, "ops": {}, "requests": 1, "window_s": 0.0, "busy_s": 0.0,
             "k1_bound_ms": 1.0, "flops": 1.0, "peak_flops": 1.0}
    assert read(empty) is None
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    assert any(cells.metric_file(m["name"]) == path for m in cells.benchmark()["per_layer"])


@pytest.mark.parametrize("name", [m["name"] for m in cells.benchmark()["per_layer"]])
def test_every_per_layer_metric_has_a_reader(name):
    assert os.path.exists(cells.metric_file(name)), name
    assert callable(cells.metric_reader(name))


@pytest.mark.parametrize("name", _mixes("songs"))
def test_song_traffic_writes_what_it_says(name, tmp_path):
    from benchmark.drivers import train

    mix = dict(traffic.load(name), songs=2, rows=5, song_s=[2, 3])
    data = train.write_data(mix, 2 ** 31 + 1, str(tmp_path))
    again = train.write_data(mix, 2 ** 31 + 1, str(tmp_path / "again"))
    assert [s["T"] for s in data["songs"]] == [s["T"] for s in again["songs"]]
    assert all(150 <= s["T"] <= 225 for s in data["songs"])
    assert os.path.exists(os.path.join(data["manifest"], "music.tsv"))
