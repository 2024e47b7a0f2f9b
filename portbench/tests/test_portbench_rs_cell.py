"""The plain RS (9, 6) cell, ``rs-6-3-64mib-node-repair``, on the CPU at a
size a test run holds (4 KiB blocks, 8 stripes): its files are found by
name, a traced run is correct and reads 6 source blocks a rebuilt block,
the control makes it incorrect, and the reference's parity rows are the
program's RS (9, 6) parity matrix, so ``check.py`` judges the rebuilt
blocks of a row family with no edit."""

import time

import numpy as np

from portbench import bench, faults, spec
from portbench.reference.code import CoreCode

CELL = "rs-6-3-64mib-node-repair"
SMALL = {"block_bytes": 4096, "num_groups": 8}


def cpu_run(tmp_path, trace=False, fault=None, seed=2**31 + 30):
    return bench.run_cell(CELL, seed, 0.5, trace, device="cpu", cache_dir=tmp_path,
                          started=time.perf_counter(), config_overrides=SMALL,
                          gateway_overrides={"autotune": False}, fault=fault)


def test_cell_loads_by_name():
    entry, config, workload = spec.cell(spec.load(), CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == ("rs-6-3-64mib", "node-repair", 1)
    assert config["code"] == {**config["code"], "family": "rs", "n": 9, "k": 6, "t": 1,
                              "field_poly": 283}
    assert config["gateway"]["code_family"] == "rs"
    assert config["block_bytes"] == 64 << 20 and config["num_groups"] * 9 == 144
    assert workload["loop"] == "losses" and workload["mix"] == {}


def test_traced_run_is_correct_and_reads_six_sources_a_block(tmp_path):
    r = cpu_run(tmp_path, trace=True)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["repair_missing"]["value"] == r["checks"]["repair_wrong"]["value"] == 0
    assert r["metrics"]["repair.read_per_rebuilt"]["value"] == 6.0
    assert r["metrics"]["repair.plan_ms_per_GiB"]["value"] > 0


def test_control_makes_it_incorrect(tmp_path):
    r = cpu_run(tmp_path, fault=faults.zero_fill)
    assert not r["correct"] and r["checks"]["repair_wrong"]["value"] > 0


def test_reference_parity_rows_are_the_programs():
    from repro_torch.coding import rs

    ref = CoreCode.from_config(spec.cell(spec.load(), CELL)[1]["code"])
    np.testing.assert_array_equal(ref.parity, rs.parity_matrix(9, 6))
