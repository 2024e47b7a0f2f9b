"""Whole runs of every cell on the CPU at a size a test run holds (4 KiB
blocks, 8 groups, autotune off, a half-second window): a sound run is
correct and prints the result line's schema; each fault the cell can
have, planted under the timed path, makes it incorrect. The harness's
own look for a chip is skipped here by calling ``run_cell`` with
``device="cpu"``; ``run.py`` itself refuses to run without a card."""

import json
import pathlib
import subprocess
import sys
import time

import pytest

from portbench import bench, faults, spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
SMALL = {"block_bytes": 4096, "num_groups": 8}
# the two open-loop YCSB cells, measured and left out of BENCHMARK.json
# (their p95 did not hold still on the card): their files still drive a run
LEFT_OUT = {"core963-1mib-ycsb-b": "ycsb-b", "core963-1mib-ycsb-a": "ycsb-a"}


def with_left_out(bench):
    ycsb = {"workloads": list(LEFT_OUT)}
    return {
        **bench,
        "configs": bench["configs"] + [{"name": "core-9-6-3-1mib",
                                        "file": "portbench/configs/core-9-6-3-1mib.json"}],
        "workloads": bench["workloads"] + [
            {"name": c, "config": "core-9-6-3-1mib", "traffic": t, "chips": 1}
            for c, t in LEFT_OUT.items()],
        "end_to_end": bench["end_to_end"] + [{"name": "op_p95_ms", "unit": "ms", **ycsb}],
        "per_layer": bench["per_layer"] + [
            {"name": n, "unit": u, "moves": "op_p95_ms", **ycsb}
            for n, u in (("gateway.host_ms_per_op.ycsb", "ms"), ("device.idle_pct.ycsb", "%"))],
    }


BENCH = with_left_out(spec.load())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(autouse=True)
def left_out_cells(monkeypatch):
    monkeypatch.setattr(spec, "load", lambda root=spec.ROOT: BENCH)


def cpu_run(cell, tmp_path, seed=2**31 + 11, trace=False, fault=None):
    return bench.run_cell(cell, seed, 0.5, trace, device="cpu", cache_dir=tmp_path,
                          started=time.perf_counter(), config_overrides=SMALL,
                          gateway_overrides={"autotune": False}, fault=fault)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_well_formed(cell, trace, tmp_path):
    r = cpu_run(cell, tmp_path, trace=trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"] and all(c["value"] <= c["limit"] == 0 for c in r["checks"].values())
    want = {m["name"] for m in spec.metrics_for(BENCH, cell, trace)}
    assert set(r["metrics"]) <= want
    if not trace:
        assert {"setup_s"} < set(r["metrics"])
    else:
        assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    json.dumps(r)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault, tmp_path):
    r = cpu_run(cell, tmp_path, fault=faults.FAULTS[fault])
    assert not r["correct"], r["checks"]


def test_run_py_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_run_py_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "7",
         "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
