"""``integrity.crc32_fold_pct``: its arithmetic on hand-made runs, None
for reports that carry no ``host_crc32_bytes`` (a program without the
counter), and on a traced CPU run of each node-repair cell the share the
program's own counter gives: all of it at 64 KiB blocks, none at 4 KiB,
which lie under the fold's ``FOLD_MIN_BYTES`` and go through zlib."""

import time

import pytest

from portbench import bench, spec
from portbench.bench import Run
from repro_torch.obs import MetricsRegistry
from repro_torch.storage import crc32

METRIC = "integrity.crc32_fold_pct"


def run_of(*reports):
    """A run whose window held one report per dict of impl -> bytes."""
    run = Run("cell", {}, {}, 1 << 26, 6)
    run.reports = []
    for counts in reports:
        m = MetricsRegistry()
        for impl, nbytes in counts.items():
            m.counter("host_crc32_bytes", impl=impl).inc(nbytes)
        run.reports.append(type("Report", (), {"metrics": m})())
    return run


@pytest.mark.parametrize("reports,want", [
    (({"fold": 3 << 26}, {"fold": 1 << 26, "zlib": 1 << 12}), 100 * (4 << 26) / ((4 << 26) + 4096)),
    (({"zlib": 4096},), 0.0),
    (({"fold": 1 << 26},), 100.0),
    ((), None),
    (({},), None),
])
def test_reader_arithmetic(reports, want):
    got = spec.reader(METRIC)(run_of(*reports))
    assert got == (None if want is None else pytest.approx(want))


def test_metric_lists_both_node_repair_cells():
    (m,) = [m for m in spec.load()["per_layer"] if m["name"] == METRIC]
    assert m["workloads"] == ["core963-64mib-node-repair", "rs-6-3-64mib-node-repair"]
    assert (m["source"], m["moves"], m["unit"]) == ("program_counter", "repair_GiBps", "%")
    for cell in m["workloads"]:
        assert METRIC in [x["name"] for x in spec.metrics_for(spec.load(), cell, True)]
        assert METRIC not in [x["name"] for x in spec.metrics_for(spec.load(), cell, False)]


@pytest.mark.parametrize("block_bytes", [4096, 65536])
@pytest.mark.parametrize("cell", ["core963-64mib-node-repair", "rs-6-3-64mib-node-repair"])
def test_traced_cpu_run_reads_the_fold_share(cell, block_bytes, tmp_path):
    if not crc32.fast_path():
        pytest.skip(f"the fold does not run on this host: {crc32.build_error or 'no PCLMULQDQ'}")
    r = bench.run_cell(cell, 2**31 + 31, 0.5, True, device="cpu", cache_dir=tmp_path,
                       started=time.perf_counter(),
                       config_overrides={"block_bytes": block_bytes, "num_groups": 8},
                       gateway_overrides={"autotune": False})
    assert r["correct"]
    want = 100.0 if block_bytes >= crc32.FOLD_MIN_BYTES else 0.0
    assert r["metrics"][METRIC]["value"] == want
