"""The metric arithmetic on synthetic runs and a synthetic profiler
table, and the open loop's lateness and tail as the knee sweep reads
them."""

import math

import pytest

from portbench import devtrace, peaks, spec
from portbench.bench import Loss, Op, Run
from portbench.knee import summarize, sustained


def run_of(ops=(), losses=(), window_s=10.0, q=1 << 20, trace=None, **stats):
    run = Run("cell", {}, {}, q, 6, setup_s=12.5, window_s=window_s, ops=list(ops),
              losses=list(losses), trace=trace)
    run.stats_before = {"decode_calls": 0, "ops_by_kind": {}, "sources_by_kind": {}}
    run.stats_after = {"decode_calls": 0, "ops_by_kind": {}, "sources_by_kind": {}, **stats}
    return run


def op(kind, due, done, ok=True):
    return Op(kind, 0, due, due, issued=due, done=done, ok=ok)


def read(name, run):
    return spec.reader(name)(run)


def test_p95_nearest_rank_over_all_requests_due():
    ops = [op("get", i, i + (i + 1) / 1000) for i in range(100)]
    assert read("op_p95_ms", run_of(ops)) == pytest.approx(95.0)
    ops[0] = op("get", 0, 5.0)  # one slow request moves the rank, not the value
    assert read("op_p95_ms", run_of(ops)) == pytest.approx(96.0)


def test_p95_counts_a_failed_request_as_missing():
    ops = [op("put", i, i + 0.001) for i in range(19)] + [op("get", 19, 19.001, ok=False)]
    assert read("op_p95_ms", run_of(ops)) == pytest.approx(1.0)
    ops[0].ok = False
    assert read("op_p95_ms", run_of(ops)) is None


def test_rates_over_the_whole_window():
    ops = [op("get", 0, 1), op("get", 1, 2), op("get", 2, 3, ok=False), op("put", 3, 4)]
    assert read("get_GiBps", run_of(ops, q=1 << 30, window_s=4.0)) == pytest.approx(2 * 6 / 4)
    losses = [Loss(1, [], 0, 2, blocks_repaired=3, bytes_fetched=9 << 30),
              Loss(2, [], 2, 2.1, blocks_repaired=0)]
    run = run_of(losses=losses, q=1 << 30, window_s=6.0)
    assert read("repair_GiBps", run) == pytest.approx(0.5)
    assert read("repair.read_per_rebuilt", run) == pytest.approx(3.0)
    assert read("setup_s", run) == 12.5


def synthetic_trace():
    t = devtrace.Trace()
    t.spans = [("portbench.window", 0.0, 10.0), ("portbench.serve", 0.0, 4.0),
               ("portbench.wait", 4.0, 6.0), ("portbench.serve", 6.0, 10.0)]
    t.device = [("Memcpy HtoD (Pinned -> Device)", 1.0, 1.5), ("xor_tiles_kernel<4>", 1.5, 1.6),
                ("Memcpy DtoH (Device -> Pageable)", 1.6, 2.0), ("xor_tiles_kernel<4>", 7.0, 7.1),
                ("elementwise", 7.05, 7.2), ("outside", 11.0, 12.0)]
    return t


def test_union_idle_and_breakdown():
    t = synthetic_trace()
    assert t.busy_s(0, 10) == pytest.approx(1.2)
    assert t.busy_s(0, 10, "kernels") == pytest.approx(0.3)
    assert t.busy_s(0, 10, "copies") == pytest.approx(0.9)
    gaps = dict(devtrace.idle_gaps(t, 0, 10))
    assert sum(gaps.values()) == pytest.approx(8.8)
    assert gaps["serve after window start"] == pytest.approx(1.0)
    assert gaps["wait after Memcpy DtoH (Device -> Pageable)"] == pytest.approx(5.0)
    b = devtrace.breakdown(t, 0, 10)
    assert b["device_ops"][0] == ["Memcpy HtoD (Pinned -> Device)", pytest.approx(0.5)]
    assert len(b["idle_gaps"]) <= 10 and len(b["device_ops"]) <= 10
    run = run_of(trace=t)
    for name in ("device.idle_pct.get", "device.idle_pct.ycsb", "device.idle_pct.repair"):
        assert read(name, run) == pytest.approx(88.0)


def test_decode_metrics():
    t = synthetic_trace()
    run = run_of(trace=t, q=1 << 26, decode_calls=64,
                 ops_by_kind={"V": 2, "EV": 9}, sources_by_kind={"V": 6, "EV": 27})
    run.decode_out_bytes = 2 << 26
    assert read("coalescer.launches_per_GiB.get", run) == pytest.approx(64 / 0.125)
    assert read("coalescer.copy_ms_per_GiB.get", run) == pytest.approx(900 / 0.125)
    want = 8 * (1 << 26) / peaks.HBM_BYTES_PER_S / 0.3 * 100
    assert read("kernels.decode_roofline", run) == pytest.approx(want)
    assert read("kernels.decode_roofline", run_of(trace=None)) is None


def test_digest_time_per_GiB_served():
    ops = [op("get", i, i + 0.1) for i in range(4)] + [op("get", 9, 9.5, ok=False)]
    run = run_of(ops, q=1 << 26)
    assert read("gateway.digest_ms_per_GiB.get", run) is None
    run.digest_s = 1.5
    assert read("gateway.digest_ms_per_GiB.get", run) == pytest.approx(1500 / 1.5)


def test_host_time_per_op():
    ops = [op("get", i, i + 0.1) for i in range(8)]
    run = run_of(ops, trace=synthetic_trace())
    assert read("gateway.host_ms_per_op.ycsb", run) == pytest.approx((8.0 - 1.2) / 8 * 1e3)


def test_repair_roofline():
    losses = [Loss(1, [], 0, 1, blocks_repaired=2, bytes_fetched=6 << 26)]
    run = run_of(losses=losses, q=1 << 26, trace=synthetic_trace())
    want = (8 << 26) / peaks.HBM_BYTES_PER_S / 0.3 * 100
    assert read("codec.repair_roofline", run) == pytest.approx(want)


def test_knee_summary():
    ops = [op("get", i * 0.1, i * 0.1 + 0.02) for i in range(100)]
    for o in ops[-10:]:
        o.issued = o.due + 0.5
    point = summarize(ops, 10.0, 10.3, 10.0)
    assert point["requests"] == 100 and point["p95_ms"] == pytest.approx(20.0)
    assert point["late_tail_s"] == pytest.approx(0.5) and point["drain_s"] == pytest.approx(0.3)
    assert not sustained(point)
    point["late_tail_s"] = 0.0
    assert sustained(point) and not sustained(point, p95_limit_ms=19.0)
    assert math.isinf(summarize([op("get", 0, 1, ok=False)], 1, 1, 1)["p95_ms"])
