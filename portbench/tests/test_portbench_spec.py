"""BENCHMARK.json against the contract the driver checks, and the
discovery of cells, configurations and metrics by name."""

import json
import re

import pytest

from portbench import spec

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry, config, workload = spec.cell(BENCH, cell)
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert config["name"] == conf["name"] and config["reduced"] == conf["reduced"]
    assert workload["name"] == cell
    e2e = spec.metrics_for(BENCH, cell, trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = spec.metrics_for(BENCH, cell, trace=True)
    assert layer and all(m["moves"] in names for m in layer)
    for m in e2e + layer:
        assert callable(spec.reader(m["name"]))


def test_every_config_is_used_and_every_metric_has_a_reader():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.reader_path(m["name"]).is_file()
        for cell in m.get("workloads", []):
            assert cell in CELLS


def test_per_layer_metric_without_workloads_follows_its_end_to_end_metric():
    bench = {"end_to_end": [{"name": "a", "workloads": ["x"]}, {"name": "setup_s"}],
             "per_layer": [{"name": "p", "moves": "a"}, {"name": "q", "moves": "setup_s"},
                           {"name": "r", "moves": "a", "workloads": ["y"]}]}
    assert [m["name"] for m in spec.metrics_for(bench, "x", True)] == ["p", "q"]
    assert [m["name"] for m in spec.metrics_for(bench, "y", True)] == ["q", "r"]
    assert [m["name"] for m in spec.metrics_for(bench, "y", False)] == ["setup_s"]


def test_reader_falls_back_to_the_name_less_its_last_part(tmp_path):
    metrics = tmp_path / "portbench" / "metrics"
    metrics.mkdir(parents=True)
    (metrics / "a.b.py").write_text("def read(run):\n    return 'stem'\n")
    (metrics / "a.b.c.py").write_text("def read(run):\n    return 'own'\n")
    assert spec.reader("a.b.c", tmp_path)(None) == "own"
    assert spec.reader("a.b.d", tmp_path)(None) == "stem"
    assert spec.reader_path("a.b.d.e", tmp_path) == metrics / "a.b.d.e.py"
    assert spec.reader_path("x", tmp_path) == metrics / "x.py"


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no-such-cell")
