"""The port's fault-injection scenario engine (``repro_torch.scenario``)
against the JAX package's: the cases of tests/test_scenario.py run on
both packages and their results compared, tolerance 0.

The same seeds, traces and objects go to both. The JAX gateway runs
Pallas in interpret mode, the port ``device="cpu"`` (the kernels' plain
torch versions), both with ``autotune=False``. Gateway runs bill decode
with the modeled ``decode_cost`` (the golden and surge setups already
do; the others add it on both sides), so the discrete outcome never
reads the wall clock and ``deterministic_fingerprint`` must be equal.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.scenario  # noqa: E402
import repro_torch.scenario  # noqa: E402
import torch  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves, and the
    suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _side(pkg: str, kw: dict) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        pc=mod("core.product_code"), gw=mod("gateway"), wl=mod("gateway.workload"),
        sc=mod("scenario"), bs=mod("storage.blockstore"), net=mod("storage.netmodel"),
        rep=mod("storage.repair"), kw=kw, codec_kw={"device": "cpu"} if kw.get("device") else {},
    )


SIDES = {
    "jax": _side("repro", {"interpret": True, "autotune": False}),
    "torch": _side("repro_torch", {"device": "cpu", "autotune": False}),
}
MODELED = {"decode_cost": 0.002}


def both(fn, *args, **kw):
    """``fn(side, ...)`` on both packages -> (jax result, torch result)."""
    return fn(SIDES["jax"], *args, **kw), fn(SIDES["torch"], *args, **kw)


def _gateway(code, num_nodes=60, q=2048, num_objects=12, seed=9, *, s, **cfg_kw):
    gw = s.gw.ObjectGateway(
        code, s.net.ClusterProfile.network_critical(), num_nodes,
        s.gw.GatewayConfig(**cfg_kw, **s.kw),
    )
    rng = np.random.default_rng(seed)
    gw.load_objects(rng.integers(0, 256, (num_objects, code.k, q), dtype=np.uint8))
    return gw


def _records(rep):
    return [
        (r.time, r.object_id, r.kind, r.latency, r.degraded, r.rejected, r.bytes_read,
         r.reconstruction_blocks, r.cache_hits, r.tenant, r.payload_digest)
        for r in rep.records
    ]


def _repairs(rep):
    return [(r.mode, r.blocks_fetched, r.bytes_fetched, r.blocks_repaired, r.recovered)
            for r in rep.repair_reports]


def _reqs(reqs):
    return [(r.time, r.object_id, r.kind, r.tenant) for r in reqs]


def test_exports_match_the_reference():
    assert set(repro_torch.scenario.__all__) == set(repro.scenario.__all__)
    assert repro_torch.scenario.SURGE_FAIL_AT == repro.scenario.SURGE_FAIL_AT
    assert repro_torch.scenario.SURGE_END == repro.scenario.SURGE_END


# ---------------------------------------------------------------------------
# trace DSL + generators
# ---------------------------------------------------------------------------

def _generated(s, seed):
    cfg = s.sc.ScenarioConfig(
        duration=1.0, num_nodes=60, nodes_per_rack=3,
        max_concurrent_failures=3, crash_rate=20.0, mean_downtime=0.05,
        transient_fraction=0.5, rack_burst_times=(0.2, 0.7),
        flap_nodes=2, seed=seed,
    )
    trace = s.sc.generate_scenario(cfg)
    assert s.sc.generate_scenario(cfg).to_jsonable() == trace.to_jsonable()
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_generated_traces_equal_and_respect_tolerance_bound(seed):
    ref, port = both(_generated, seed)
    assert port.to_jsonable() == ref.to_jsonable()
    assert port.max_concurrent_down() == ref.max_concurrent_down() <= 3
    assert port.events
    times = [e.time for e in port.cluster_events()]
    assert times == sorted(times)


def _rack_trace(s):
    trace = s.sc.rack_failure(s.sc.ScenarioTrace(num_nodes=12, nodes_per_rack=4), 0.5,
                              rack=1, downtime=0.3)
    trace = s.sc.flapping_node(trace, node=0, start=1.0, period=0.2, count=2)
    return s.sc.load_surge(trace, 0.5, 0.3, 2.5)


def test_rack_failure_expands_equal_and_json_crosses_packages():
    ref, port = both(_rack_trace)
    assert port.to_jsonable() == ref.to_jsonable()
    crashed = {e.node for e in port.events if isinstance(e, SIDES["torch"].wl.FailureEvent)}
    assert {4, 5, 6, 7} <= crashed
    # a trace written by either package loads in the other
    again = repro_torch.scenario.trace_from_jsonable(ref.to_jsonable())
    assert again.to_jsonable() == ref.to_jsonable()
    assert again.surges == port.surges and again.num_nodes == port.num_nodes
    back = repro.scenario.trace_from_jsonable(port.to_jsonable())
    assert back.to_jsonable() == port.to_jsonable()


def _surge_reqs(s, surges, num_requests, seed):
    trace = s.sc.ScenarioTrace(num_nodes=10)
    for time, duration, mult in surges:
        trace = s.sc.load_surge(trace, time, duration, mult)
    wl = s.wl.WorkloadConfig(num_objects=20, num_requests=num_requests,
                             arrival_rate=1000.0, seed=seed)
    return _reqs(s.sc.scenario_requests(wl, trace))


@pytest.mark.parametrize(
    "surges,seed,window,base,ratio",
    [
        (((0.5, 0.5, 4.0),), 2, (0.5, 1.0), (0.0, 0.5), 2.5),  # follows one surge
        (((0.5, 0.5, 1.5), (0.75, 0.5, 1.5)), 4, (0.75, 1.0), (0.0, 0.25), 1.8),  # overlap
        (((0.0, 1.0, 0.5), (0.5, 1.5, 3.0)), 5, (1.0, 1.5), (0.5, 1.0), 1.6),  # expiry peak
    ],
    ids=["single", "overlap", "throttle-expiry"],
)
def test_scenario_requests_equal_and_follow_surges(surges, seed, window, base, ratio):
    n = 3000 if len(surges) == 1 else 4000
    ref, port = both(_surge_reqs, surges, n, seed)
    assert port == ref and len(port) == n
    count = lambda lo, hi: sum(1 for r in port if lo <= r[0] < hi)  # noqa: E731
    assert count(*window) > ratio * count(*base)


def _max_down(s):
    wl = s.wl
    trace = s.sc.ScenarioTrace(
        num_nodes=10,
        events=(
            wl.CapacityLossEvent(time=0.0, node=3), wl.FailureEvent(time=0.1, node=4),
            wl.NodeRecoverEvent(time=0.2, node=3), wl.FailureEvent(time=0.3, node=5),
            wl.NodeRecoverEvent(time=0.4, node=4),
        ),
    )
    return trace.max_concurrent_down()


def test_max_concurrent_down_counts_capacity_loss_forever():
    assert both(_max_down) == (3, 3)


# ---------------------------------------------------------------------------
# property: within-tolerance traces never lose data, on both packages alike
# ---------------------------------------------------------------------------

def _durable_run(s, seed):
    code = s.pc.CoreCode(9, 6, 3)
    cfg = s.sc.ScenarioConfig(
        duration=0.5, num_nodes=60, nodes_per_rack=3,
        max_concurrent_failures=code.n - code.k, crash_rate=12.0,
        mean_downtime=0.08, transient_fraction=0.5, flap_nodes=1, seed=seed,
    )
    gw = _gateway(code, batch_window=0.01, cache_bytes=4 * 1024 * 1024,
                  repair_on_failure=True, repair_delay=0.03, s=s, **MODELED)
    wl = s.wl.WorkloadConfig(num_objects=12, num_requests=120, arrival_rate=400.0, seed=seed)
    return s.sc.run_scenario(gw, s.sc.generate_scenario(cfg), wl)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**16))
def test_durability_property_within_tolerance(seed):
    ref, port = both(_durable_run, seed)
    assert (repro_torch.scenario.deterministic_fingerprint(port)
            == repro.scenario.deterministic_fingerprint(ref))
    assert _records(port.report) == _records(ref.report)
    assert len(port.report.records) == 120
    assert all(r.latency is not None for r in port.report.records)
    assert port.blocks_lost == 0 and port.durability["unreadable_objects"] == 0
    assert port.durability["missing_blocks"] == 0


def _beyond_tolerance(s):
    code = s.pc.CoreCode(9, 6, 3)
    gw = _gateway(code, num_objects=code.t, batch_window=0.01, repair_on_failure=True,
                  repair_delay=0.05, s=s, **MODELED)
    cols = range(code.n - code.k + 1)
    victims = {gw.store.node_of(("g0", r, c)) for r in (0, 1) for c in cols}
    events = [s.wl.CapacityLossEvent(time=0.01, node=n) for n in sorted(victims)]
    reqs = [s.wl.Request(time=0.02, object_id=0), s.wl.Request(time=0.02, object_id=2)]
    report = gw.serve(reqs, events)
    return _records(report), _repairs(report), gw.audit_durability()


def test_beyond_tolerance_reports_data_loss_without_crashing():
    ref, port = both(_beyond_tolerance)
    assert port == ref
    records, repairs, audit = port
    by_obj = {r[1]: r for r in records}
    assert by_obj[0][3] is None and by_obj[2][3] is not None
    assert audit["blocks_lost"] > 0 and audit["unreadable_objects"] >= 1
    assert repairs and not all(r[-1] for r in repairs)


# ---------------------------------------------------------------------------
# golden-trace determinism
# ---------------------------------------------------------------------------

def _golden_run(s):
    code = s.pc.CoreCode(9, 6, 3)
    gw = _gateway(
        code, batch_window=0.01, cache_bytes=4 * 2048,
        repair_on_failure=True, repair_delay=0.05, record_payloads=True,
        repair_pacing=True, tenant_slo_p99={"foreground": 0.1}, s=s, **MODELED,
    )
    base = s.sc.load_surge(s.sc.ScenarioTrace(num_nodes=60, nodes_per_rack=3), 0.1, 0.2, 2.0)
    wl = s.wl.WorkloadConfig(num_objects=12, num_requests=200, arrival_rate=600.0, seed=31)
    counts = np.bincount([r.object_id for r in s.sc.scenario_requests(wl, base)],
                         minlength=12)
    gid, row = gw._objects[int(np.argmax(counts))]
    v1 = gw.store.node_of((gid, row, 0))
    v2 = gw.store.node_of((gid, row, 2))
    trace = s.sc.ScenarioTrace(
        num_nodes=60, nodes_per_rack=3,
        events=(
            s.wl.FailureEvent(time=0.05, node=v1),
            s.wl.CapacityLossEvent(time=0.15, node=v2),
            s.wl.NodeRecoverEvent(time=0.35, node=v1),
        ),
        surges=base.surges,
    )
    return s.sc.run_scenario(gw, trace, wl)


def test_golden_trace_fingerprint_equals_the_reference():
    ref, port = both(_golden_run)
    fp = repro_torch.scenario.deterministic_fingerprint(port)
    assert fp == repro.scenario.deterministic_fingerprint(ref)
    assert fp == repro_torch.scenario.deterministic_fingerprint(_golden_run(SIDES["torch"]))
    assert port.summary() == ref.summary()
    assert _records(port.report) == _records(ref.report)
    assert port.summary()["repairs"] > 0 and port.summary()["degraded_gets"] > 0


# ---------------------------------------------------------------------------
# SLO-aware closed-loop repair pacing
# ---------------------------------------------------------------------------

def _surge_run(s, pacing):
    code = s.pc.CoreCode(9, 6, 3)
    setup = s.sc.correlated_surge_setup(code)
    gw = _gateway(code, num_nodes=setup["num_nodes"], q=setup["block_bytes"],
                  num_objects=setup["num_objects"], seed=setup["seed"],
                  repair_pacing=pacing, s=s, **setup["gateway_kwargs"])
    return s.sc.run_scenario(gw, setup["trace"], setup["workload"])


@pytest.fixture(scope="module")
def surge_runs():
    return {pacing: both(_surge_run, pacing) for pacing in (False, True)}


def test_correlated_surge_setup_equals_the_reference():
    ref, port = both(lambda s: s.sc.correlated_surge_setup(s.pc.CoreCode(14, 12, 5), 600))
    assert port["trace"].to_jsonable() == ref["trace"].to_jsonable()
    assert vars(port["workload"]) == vars(ref["workload"])
    skip = ("trace", "workload")
    assert {k: v for k, v in port.items() if k not in skip} == {
        k: v for k, v in ref.items() if k not in skip}


@pytest.mark.parametrize("pacing", [False, True], ids=["fixed", "paced"])
def test_surge_runs_equal_the_reference(surge_runs, pacing):
    ref, port = surge_runs[pacing]
    assert (repro_torch.scenario.deterministic_fingerprint(port)
            == repro.scenario.deterministic_fingerprint(ref))
    assert port.summary() == ref.summary()
    assert list(port.report.pacing) == list(ref.report.pacing)
    lo, hi = repro.scenario.SURGE_FAIL_AT, repro.scenario.SURGE_END
    assert port.p99_window(lo, hi) == ref.p99_window(lo, hi)
    assert port.p99_since(lo) == ref.p99_since(lo)


def test_paced_repair_protects_p99_and_still_converges(surge_runs):
    fixed, paced = surge_runs[False][1], surge_runs[True][1]
    lo, hi = repro_torch.scenario.SURGE_FAIL_AT, repro_torch.scenario.SURGE_END
    assert paced.p99_window(lo, hi) < fixed.p99_window(lo, hi)
    for res in (fixed, paced):
        assert res.durability["missing_blocks"] == 0 and res.blocks_lost == 0
        assert res.report.mttr_samples
    assert paced.report.mttr_mean <= 2.0 * fixed.report.mttr_mean
    same = sum(r.blocks_repaired for r in fixed.report.repair_reports)
    assert same == sum(r.blocks_repaired for r in paced.report.repair_reports) > 0
    assert paced.report.pacing and not fixed.report.pacing
    assert all(0.25 <= s <= 1.0 for _, s in paced.report.pacing)
    assert min(s for _, s in paced.report.pacing) < 0.5


def _pacing_policy(s):
    pc = s.rep.PacingController(min_share=0.2, max_share=1.0, mttr_target=10.0)
    grid = [(p99, slo, out) for p99 in (None, 0.01, 0.05, 0.08, 0.09, 0.1, 0.5)
            for slo in (None, 0.1) for out in (0.0, 15.0, 20.1)]
    shares = [pc.share(*args) for args in grid]
    errors = []
    for bad in ({"min_share": 0.0}, {"min_share": 0.9, "max_share": 0.5}):
        with pytest.raises(ValueError):
            s.rep.PacingController(**bad)
        errors.append(bad)
    return shares, errors


def test_pacing_controller_policy_equal():
    ref, port = both(_pacing_policy)
    assert port == ref
    pc = SIDES["torch"].rep.PacingController(min_share=0.2, max_share=1.0, mttr_target=10.0)
    assert pc.share(None, 0.1) == 1.0 and pc.share(0.1, 0.1) == pytest.approx(0.2)
    assert pc.share(0.5, 0.1, outstanding_for=20.1) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# negative / TTL cache entries
# ---------------------------------------------------------------------------

def _cache_negative(s):
    cache = s.gw.LRUBlockCache(capacity_bytes=1024)
    key = ("g", 0, 0)
    out = []
    cache.put_negative(key, now=1.0, ttl=2.0)
    out += [cache.is_negative(key, 1.5), cache.negative_entries]
    out += [cache.is_negative(key, 3.0), cache.negative_entries, cache.stats.negative_expired]
    cache.put_negative(key, now=1.0, ttl=100.0)
    out += [cache.purge_negative([key, ("g", 0, 9)]), cache.is_negative(key, 1.1)]
    cache.put_negative(key, now=0.0, ttl=10.0)
    cache.put(key, np.zeros(16, dtype=np.uint8))
    out += [cache.nbytes, key in cache, cache.is_negative(key, 1.0)]
    return out


def test_cache_negative_entries_ttl_and_purge():
    ref, port = both(_cache_negative)
    assert port == ref == [True, 1, False, 0, 1, 1, False, 16, True, True]


def _negative_recover(s):
    code = s.pc.CoreCode(9, 6, 3)
    gw = _gateway(code, batch_window=0.005, cache_bytes=4 * 1024 * 1024,
                  negative_ttl=50.0, s=s, **MODELED)
    victim = gw.store.node_of(("g0", 0, 0))
    events = [s.wl.FailureEvent(time=0.01, node=victim),
              s.wl.NodeRecoverEvent(time=0.5, node=victim)]
    reqs = [s.wl.Request(time=0.02 + 0.002 * i, object_id=0) for i in range(3)]
    reqs.append(s.wl.Request(time=1.0, object_id=0))
    report = gw.serve(reqs, events)
    return (_records(report), gw.cache.negative_entries, gw.cache.stats.negative_hits,
            len(report.restored_samples))


def _negative_ttl(s):
    code = s.pc.CoreCode(9, 6, 3)
    gw = _gateway(code, batch_window=0.005, cache_bytes=4 * 1024 * 1024,
                  negative_ttl=0.1, s=s, **MODELED)
    victim = gw.store.node_of(("g0", 0, 0))
    reqs = [s.wl.Request(time=0.02, object_id=0), s.wl.Request(time=5.0, object_id=0)]
    report = gw.serve(reqs, [s.wl.FailureEvent(time=0.01, node=victim)])
    return _records(report), gw.cache.stats.negative_expired


def _heal_reprice(s):
    code = s.pc.CoreCode(9, 6, 3)
    gw = _gateway(code, batch_window=0.02, cache_bytes=4 * 1024 * 1024,
                  repair_on_failure=True, repair_delay=0.05, background_share=0.5,
                  negative_ttl=1e9, s=s, **MODELED)
    victim = gw.store.node_of(("g0", 0, 0))
    key = ("g0", 0, 0)
    reqs = [s.wl.Request(time=0.03 + 0.001 * i, object_id=0) for i in range(5)]
    report = gw.serve(reqs, [s.wl.FailureEvent(time=0.01, node=victim)])
    mid = (key in gw.cache, gw.cache._cost.get(key), gw.cache.is_negative(key, 1e8))
    report2 = gw.serve([s.wl.Request(time=50.0, object_id=0)])
    return (_records(report), _repairs(report), len(report.mttr_samples), mid,
            _records(report2), gw.cache._cost[key])


def test_gateway_negative_caches_crashed_blocks_and_purges_on_recover():
    ref, port = both(_negative_recover)
    assert port == ref
    records, negatives, hits, restored = port
    assert len(records) == 4 and all(r[3] is not None for r in records)
    assert all(r[4] for r in records if r[0] < 0.5)
    assert not any(r[4] for r in records if r[0] >= 0.5)
    assert negatives == 0 and hits > 0 and restored


def test_gateway_negative_ttl_expires_without_recover_event():
    ref, port = both(_negative_ttl)
    assert port == ref
    (early, late), expired = port
    assert early[4] and not late[4] and late[8] > 0 and expired > 0


def test_repair_heal_purges_negative_and_repriced_via_hook():
    ref, port = both(_heal_reprice)
    assert port == ref
    _rec, repairs, mttr, mid, rec2, cost = port
    assert repairs and mttr
    assert mid == (True, 3, False)
    assert len(rec2) == 1 and not rec2[0][4] and cost == 1.0


# ---------------------------------------------------------------------------
# weighted engine pool
# ---------------------------------------------------------------------------

def _engine_pool(s):
    out = []
    pool = s.gw.EnginePool(2)
    out += [pool.dispatch(0.0, 1.0, tenant="a"), pool.dispatch(0.0, 1.0, tenant="b"),
            pool.dispatch(0.0, 1.0), pool.earliest_start(0.0)]
    pool = s.gw.EnginePool(1, weights={"repair": 0.25})
    for _ in range(4):
        pool.dispatch(0.0, 0.1, tenant="repair")
    out += [pool.free[0], pool.earliest_start(0.15)]
    pool = s.gw.EnginePool(1, weights={"repair": 0.25})
    out += [pool.dispatch(0.0, 1.0, tenant="fg"), pool.dispatch(1.0, 1.0, tenant="repair"),
            pool.dispatch(1.0, 1.0, tenant="repair"), pool.dispatch(0.0, 1.0, tenant="fg")]
    pool.set_weight("repair", 1.0)
    out.append(pool.dispatch(3.0, 1.0, tenant="repair"))
    with pytest.raises(ValueError):
        pool.set_weight("repair", 0.0)
    with pytest.raises(ValueError):
        s.gw.EnginePool(1, weights={"x": 2.0})
    return out


def test_engine_pool_dispatch_equal():
    ref, port = both(_engine_pool)
    assert port == ref
    assert port[:4] == [(0.0, 1.0), (0.0, 1.0), (1.0, 2.0), 1.0]
    assert port[4] > 1.0 and port[5] < 0.2
    assert port[6:] == [(0.0, 1.0), (1.0, 2.0), (5.0, 6.0), (2.0, 3.0), (3.0, 4.0)]


def test_gateway_rejects_zero_repair_budget():
    for s in SIDES.values():
        with pytest.raises(ValueError):
            s.gw.ObjectGateway(
                s.pc.CoreCode(9, 6, 3), s.net.ClusterProfile.network_critical(), 60,
                s.gw.GatewayConfig(repair_on_failure=True, repair_groups_per_run=0, **s.kw),
            )


def _stuck_group(s):
    code = s.pc.CoreCode(9, 6, 3)
    gw = _gateway(code, num_objects=code.t, batch_window=0.01, repair_on_failure=True,
                  repair_delay=0.05, s=s, **MODELED)
    cols = list(range(code.n - code.k + 1))
    lost = sorted({gw.store.node_of(("g0", 0, c)) for c in cols})
    crash = sorted({gw.store.node_of(("g0", 1, c)) for c in cols})
    events = [s.wl.CapacityLossEvent(time=0.01, node=n) for n in lost]
    events += [s.wl.FailureEvent(time=0.01, node=n) for n in crash]
    events += [s.wl.NodeRecoverEvent(time=1.0, node=n) for n in crash]
    report = gw.serve([s.wl.Request(time=0.02, object_id=2)], events)
    return _records(report), _repairs(report), gw.audit_durability(), len(report.mttr_samples)


def test_recovery_retriggers_repair_of_stuck_group():
    ref, port = both(_stuck_group)
    assert port == ref
    _rec, repairs, audit, mttr = port
    assert any(not r[-1] for r in repairs) and any(r[-1] and r[3] for r in repairs)
    assert audit["missing_blocks"] == 0 and audit["blocks_lost"] == 0 and mttr


def _dense_fallback(s):
    code = s.pc.CoreCode(9, 6, 3)
    store = s.bs.BlockStore(num_nodes=20)
    rng = np.random.default_rng(0)
    objects = rng.integers(0, 256, size=(code.t, code.k, 256), dtype=np.uint8)
    store.put_group("g0", np.asarray(s.pc.CoreCodec(code, **s.codec_kw).encode(objects)))
    victim = store.node_of(("g0", 0, 0))
    store.fail_nodes([victim])
    store.put_block(("g0", 0, 0), np.zeros(256, dtype=np.uint8))
    return victim, dict(store.placement), sorted(store.failed_nodes)


def test_put_block_dense_fallback_keeps_row_col_anticolocation():
    ref, port = both(_dense_fallback)
    assert port == ref
    victim, placement, failed = port
    new_node = placement[("g0", 0, 0)]
    assert new_node != victim and new_node not in failed
    for k, n in placement.items():
        if k != ("g0", 0, 0) and n not in failed and (k[1] == 0 or k[2] == 0):
            assert n != new_node, (k, n)
