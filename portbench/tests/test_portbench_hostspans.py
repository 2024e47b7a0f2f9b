"""The program's host spans in the benchmark: the program's ranges, as
the profiler records them, leave ``devtrace``'s reading of a trace as it
was (no device work, no span, the same idle gaps), the span readers'
arithmetic on hand-made runs, and on a traced CPU run of each cell the
program's own count of decode output against the harness's."""

import time

import pytest
from torch.autograd import DeviceType

from portbench import bench, devtrace, spec
from portbench.bench import Loss, Op, Run
from repro_torch.obs import MetricsRegistry


class Event:
    """What ``from_profiler`` reads of a kineto event."""

    def __init__(self, name, start, end, device):
        self._name, self._start, self._dur, self._dev = name, start, end - start, device

    def name(self):
        return self._name

    def start_ns(self):
        return int(round(self._start * 1e9))

    def duration_ns(self):
        return int(round(self._dur * 1e9))

    def device_type(self):
        return self._dev


class Profile:
    def __init__(self, events):
        results = type("Results", (), {"events": lambda self: events})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
HARNESS = [Event("portbench.window", 0, 10, CPU), Event("portbench.window", 0, 10, CUDA),
           Event("portbench.serve", 0, 4, CPU), Event("portbench.wait", 4, 6, CPU),
           Event("portbench.serve", 6, 10, CPU), Event("aten::copy_", 1, 1.5, CPU),
           Event("Memcpy HtoD (Pinned -> Device)", 1, 1.5, CUDA),
           Event("xor_tiles_kernel<4>", 1.5, 1.6, CUDA),
           Event("Memcpy DtoH (Device -> Pageable)", 1.6, 2, CUDA),
           Event("xor_tiles_kernel<4>", 7, 7.1, CUDA), Event("elementwise", 7.05, 7.2, CUDA),
           Event("outside", 11, 12, CUDA)]
# the program's ranges as the profiler records them: function-scope
# operator ranges on the host, never on the device's annotation track
PROGRAM = [Event(f"repro_torch.{n}", s, e, CPU) for n, s, e in (
    ("gateway.serve", 0.1, 3.9), ("gateway.fetch", 0.2, 0.9), ("coalescer.launch", 1.0, 2.0),
    ("gateway.sha256", 2.1, 3.8), ("gateway.serve", 6.1, 9.9), ("repair.verify", 7.3, 9.8))]
# the reading of HARNESS
BREAKDOWN = {
    "device_ops": [["Memcpy HtoD (Pinned -> Device)", 0.5],
                   ["Memcpy DtoH (Device -> Pageable)", 0.3999999999999999],
                   ["xor_tiles_kernel<4>", 0.19999999999999973],
                   ["elementwise", 0.15000000000000036]],
    "idle_gaps": [["wait after Memcpy DtoH (Device -> Pageable)", 5.0],
                  ["serve after elementwise", 2.8], ["serve after window start", 1.0]]}


@pytest.mark.parametrize("program", [[], PROGRAM], ids=["harness", "with_program"])
def test_the_programs_ranges_leave_the_reading_as_it_was(program):
    trace = devtrace.from_profiler(Profile(HARNESS + program))
    assert devtrace.breakdown(trace, 0, 10) == BREAKDOWN
    assert [name for name, _s, _e in trace.spans] == [
        "portbench.window", "portbench.serve", "portbench.wait", "portbench.serve"]
    assert [name for name, _s, _e in trace.device] == [
        e.name() for e in HARNESS if e.device_type() == CUDA
        and not e.name().startswith("portbench.")]
    assert trace.busy_s(0, 10) == pytest.approx(1.2)


def run_of(spans: dict | None, ops=(), losses=(), q=1 << 26, out=None):
    """A run whose window held one serve call recording ``spans``
    (name -> (inclusive s, self s)), or none at all (untraced)."""
    run = Run("cell", {}, {}, q, 6, ops=list(ops), losses=list(losses))
    run.stats_before = {"decode_out_bytes": 0} if out is not None else {}
    run.stats_after = {"decode_out_bytes": out} if out is not None else {}
    m = MetricsRegistry()
    for name, (incl, own) in (spans or {}).items():
        m.counter("host_s", span=name).inc(incl)
        m.counter("host_self_s", span=name).inc(own)
        m.counter("host_calls", span=name).inc()
    run.reports = [type("Report", (), {"metrics": m})()]
    return run


GETS = [Op("get", 0, 0.0, 0.0, ok=True) for _ in range(4)] + [Op("get", 1, 0.0, 0.0)]
SPANS = {"gateway.serve": (10.0, 0.5), "gateway.fetch": (1.5, 1.5),
         "gateway.assemble": (0.3, 0.3), "gateway.sha256": (0.75, 0.75),
         "coalescer.stage": (0.2, 0.2), "coalescer.scatter": (0.05, 0.05),
         "coalescer.launch": (0.4, 0.4), "coalescer.d2h": (0.1, 0.1),
         "repair.verify": (6.0, 6.0), "repair.fetch": (0.5, 0.5),
         "repair.codec": (1.0, 1.0), "repair.put": (1.5, 1.5)}
GET_GIB = 4 * 6 * (1 << 26) / 2**30  # 1.5 GiB of payload served
OUT_GIB = 0.5


@pytest.mark.parametrize("metric,want", [
    ("gateway.fetch_ms_per_GiB.get", 1500 / GET_GIB),
    ("gateway.assemble_ms_per_GiB.get", 300 / GET_GIB),
    ("gateway.sha256_ms_per_GiB.get", 750 / GET_GIB),
    ("coalescer.host_copy_ms_per_GiB.get", 250 / OUT_GIB),
    ("coalescer.device_wait_ms_per_GiB.get", 500 / OUT_GIB),
    ("gateway.untraced_pct.get", 5.0),
])
def test_get_span_readers(metric, want):
    read = spec.reader(metric)
    assert read(run_of(SPANS, GETS, out=1 << 29)) == pytest.approx(want)
    assert read(run_of(None, GETS, out=1 << 29)) is None


@pytest.mark.parametrize("metric,want", [
    ("repair.verify_ms_per_GiB", 6000 / 0.5), ("repair.fetch_ms_per_GiB", 500 / 0.5),
    ("repair.device_wait_ms_per_GiB", 1000 / 0.5), ("repair.put_ms_per_GiB", 1500 / 0.5),
    ("gateway.untraced_pct.repair", 5.0),
])
def test_repair_span_readers(metric, want):
    losses = [Loss(3, [], 0.0, 1.0, blocks_repaired=8, bytes_fetched=24 << 26)]
    read = spec.reader(metric)
    assert read(run_of(SPANS, losses=losses)) == pytest.approx(want)
    assert read(run_of(None, losses=losses)) is None


def test_coalescer_readers_read_nothing_without_the_programs_counter():
    """A program without ``CoalescerStats.decode_out_bytes`` (the parent
    of this metric) gives no denominator: None, no exception."""
    for metric in ("coalescer.host_copy_ms_per_GiB.get", "coalescer.device_wait_ms_per_GiB.get"):
        assert spec.reader(metric)(run_of(SPANS, GETS)) is None


@pytest.mark.parametrize("cell", ["core963-64mib-degraded-get", "core963-64mib-node-repair"])
def test_traced_cpu_run_reads_every_span_metric(cell, tmp_path, monkeypatch):
    runs = []

    class Kept(Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runs.append(self)

    monkeypatch.setattr(bench, "Run", Kept)
    r = bench.run_cell(cell, 2**31 + 29, 0.5, True, device="cpu", cache_dir=tmp_path,
                       started=time.perf_counter(),
                       config_overrides={"block_bytes": 4096, "num_groups": 8},
                       gateway_overrides={"autotune": False})
    assert r["correct"]
    new = [m["name"] for m in spec.load()["per_layer"]
           if m["source"] == "program_span" and m["workloads"] == [cell]
           and m["name"] != "gateway.digest_ms_per_GiB.get"]
    assert len(new) in (5, 6)
    for name in new:
        assert r["metrics"][name]["value"] > 0, name
    untraced = r["metrics"][next(n for n in new if n.startswith("gateway.untraced_pct"))]
    assert untraced["value"] < 100
    (run,) = runs
    if cell.endswith("degraded-get"):
        out = run.stats_after["decode_out_bytes"] - run.stats_before["decode_out_bytes"]
        assert out == run.decode_out_bytes > 0
