"""The port's wall-clock host spans (``repro_torch.obs.host``): a small
CORE (9, 6, 3) gateway on the CPU serves degraded GETs and then a
capacity loss with repair, once under ``torch.profiler`` and once
without. Traced, every span records, its bytes and calls match what the
serve did, inclusive time is self time plus children, and the profiler
saw each range as often as the counters say, each on the host alone.
Untraced, the reports hold
no host counters and the run is the same run: records, payload digests
and rebuilt bytes are identical."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.product_code import CoreCode
from repro_torch.gateway import GatewayConfig, ObjectGateway
from repro_torch.gateway.workload import CapacityLossEvent, FailureEvent, Request
from repro_torch.obs import MetricsRegistry, host
from repro_torch.storage.netmodel import ClusterProfile

Q = 4096  # block bytes
K = 6
ROOT = "gateway.serve"
# every span the serve path records, each a direct child of the root
SPANS = ("gateway.plan", "gateway.fetch", "gateway.decode_check", "coalescer.stage",
         "coalescer.launch", "coalescer.d2h", "coalescer.scatter", "gateway.assemble",
         "gateway.sha256", "repair.verify", "repair.fetch", "repair.codec", "repair.put")
PARENT = {name: ROOT for name in SPANS}
COUNTERS = ("host_s", "host_self_s", "host_bytes", "host_calls")


def _serve(coalesce: str):
    """(gateway, reports) of a crash, 24 GETs (the crashed node's objects
    degraded) and a capacity loss, each repaired after the GETs; billing
    modelled, so the simulated clock never reads the wall clock."""
    billing = {"decode_cost_per_tile": 1e-5} if coalesce == "ragged" else {"decode_cost": 2e-3}
    cfg = GatewayConfig(device="cpu", autotune=False, coalesce=coalesce, verify=False,
                        record_payloads=True, repair_on_failure=True, repair_delay=10.0,
                        batch_window=0.01, **billing)
    gw = ObjectGateway(CoreCode(9, K, 3), ClusterProfile.network_critical(), 60, cfg)
    gw.load_objects(np.random.default_rng(3).integers(0, 256, (12, K, Q), dtype=np.uint8))
    crashed = gw.store.node_of(("g0", 0, 0))
    gets = [Request(0.001 + 0.002 * i, i % 12) for i in range(24)]
    first = gw.serve(gets, [FailureEvent(0.0, crashed)])
    lost = gw.store.node_of(("g1", 1, 2))
    second = gw.serve([], [CapacityLossEvent(20.0, lost)])
    return gw, [first, second]


def _counters(reports) -> dict:
    out = {}
    for c in COUNTERS:
        for name in (ROOT, *SPANS):
            out[c, name] = sum(r.metrics.counter_total(c, span=name) for r in reports)
    return out


@pytest.fixture(scope="module", params=["ragged", "bucketed"])
def runs(request):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _serve(request.param)
    seen = {}
    for ev in prof.events():
        if ev.name.startswith("repro_torch."):
            name = ev.name.removeprefix("repro_torch.")
            seen[name] = seen.get(name, 0) + 1
    kinds = {(ev.is_user_annotation(), ev.device_type())
             for ev in prof.profiler.kineto_results.events()
             if ev.name().startswith("repro_torch.")}
    return traced, _serve(request.param), seen, kinds


def test_every_span_records(runs):
    (_gw, reports), _plain, _seen, _kinds = runs
    got = _counters(reports)
    for name in (ROOT, *SPANS):
        assert got["host_calls", name] > 0, name
        assert got["host_s", name] > 0, name
    assert got["host_calls", ROOT] == 2


def test_bytes_and_calls_match_the_work(runs):
    (_gw, reports), _plain, _seen, _kinds = runs
    got = _counters(reports)
    served = sum(rec.payload_digest is not None for r in reports for rec in r.records)
    assert served == 24
    assert got["host_bytes", "gateway.sha256"] == K * Q * served
    assert got["host_bytes", "gateway.assemble"] == K * Q * served
    assert got["host_calls", "gateway.sha256"] == served
    rebuilt = sum(rep.blocks_repaired for r in reports for rep in r.repair_reports)
    fetched = sum(rep.bytes_fetched for r in reports for rep in r.repair_reports)
    assert rebuilt > 0
    assert got["host_calls", "repair.put"] == rebuilt
    assert got["host_bytes", "repair.put"] == rebuilt * Q
    assert got["host_bytes", "repair.codec"] == rebuilt * Q
    assert got["host_bytes", "repair.fetch"] == fetched
    assert got["host_bytes", "coalescer.d2h"] == got["host_bytes", "coalescer.scatter"]


def test_inclusive_is_self_plus_children(runs):
    (_gw, reports), _plain, _seen, _kinds = runs
    got = _counters(reports)
    for name in (ROOT, *SPANS):
        children = sum(got["host_s", c] for c, p in PARENT.items() if p == name)
        assert got["host_s", name] == pytest.approx(
            got["host_self_s", name] + children, abs=1e-6), name
    assert 0 < got["host_self_s", ROOT] < got["host_s", ROOT]


def test_profiler_saw_each_range_as_often_as_counted(runs):
    (_gw, reports), _plain, seen, _kinds = runs
    got = _counters(reports)
    assert seen == {name: int(got["host_calls", name]) for name in (ROOT, *SPANS)}


def test_ranges_stay_on_the_host(runs):
    """Each range is a host event of function scope, never a user
    annotation: the profiler copies a user annotation onto the device's
    annotation track, where a reader of the trace takes it for device
    time."""
    *_, kinds = runs
    assert kinds == {(False, DeviceType.CPU)}


def test_untraced_run_records_nothing_and_is_the_same_run(runs):
    (gw, reports), (gw_plain, plain), _seen, _kinds = runs
    for r in plain:
        assert not any(k.startswith("host_") for k in r.metrics.snapshot()["counters"])
    for r, p in zip(reports, plain):
        assert [(x.time, x.object_id, x.latency, x.degraded, x.payload_digest)
                for x in r.records] == [(x.time, x.object_id, x.latency, x.degraded,
                                         x.payload_digest) for x in p.records]
        assert [(x.blocks_repaired, x.bytes_fetched) for x in r.repair_reports] == [
            (x.blocks_repaired, x.bytes_fetched) for x in p.repair_reports]
    assert gw.store.blocks.keys() == gw_plain.store.blocks.keys()
    for key, blk in gw.store.blocks.items():
        assert np.array_equal(blk, gw_plain.store.blocks[key]), key
    assert gw.coalescer.stats.decode_out_bytes == gw_plain.coalescer.stats.decode_out_bytes > 0


def test_decode_out_bytes_counts_what_execute_returns(runs):
    (_gw, reports), (gw_plain, _plain), _seen, _kinds = runs
    got = _counters(reports)
    # each output crosses back from the device once (its padded tiles in
    # the ragged path, the ladder's filler rows in the bucketed one)
    assert gw_plain.coalescer.stats.decode_out_bytes <= got["host_bytes", "coalescer.d2h"]
    assert gw_plain.coalescer.stats.decode_out_bytes == got["host_bytes", "gateway.decode_check"]


def test_span_is_a_shared_no_op_outside_a_recording():
    a, b = host.span("x"), host.span("y", 5, object_id=1)
    assert a is b
    with a as sp:
        sp.nbytes = 7
    reg = MetricsRegistry()
    assert not torch.autograd._profiler_enabled()
    with host.recording(reg, "root"):
        with host.span("x"):
            pass
    assert reg.snapshot()["counters"] == {}


def test_recording_nests_spans_and_restores_the_previous_registry():
    outer, inner = MetricsRegistry(), MetricsRegistry()
    with profile(activities=[ProfilerActivity.CPU]):
        with host.recording(outer, "root"):
            with host.span("a", 3) as sp:
                with host.recording(inner, "nested"):
                    with host.span("b"):
                        pass
                sp.nbytes += 4
            with host.span("a"):
                pass
    assert host.span("x") is host.span("y")
    tot = outer.counter_total
    assert tot("host_calls", span="a") == 2 and tot("host_bytes", span="a") == 7
    assert tot("host_calls", span="b") == 0 and tot("host_calls", span="root") == 1
    assert inner.counter_total("host_calls", span="nested") == 1
    assert inner.counter_total("host_calls", span="b") == 1
    nested = inner.counter_total("host_s", span="nested")
    assert tot("host_s", span="a") == pytest.approx(
        tot("host_self_s", span="a") + nested, abs=1e-9)
    assert tot("host_s", span="root") == pytest.approx(
        tot("host_self_s", span="root") + tot("host_s", span="a"), abs=1e-9)
