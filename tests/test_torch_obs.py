"""The port's observability plane (``repro_torch.obs``) against the JAX
package's: the cases of tests/test_obs.py (streaming estimators, bounded
containers, the metrics registry, tracer sampling, gateway spans and
their critical path, the observation-only contract over the scenario
engine, the chrome-tracing exporter) run on both packages and their
results compared, tolerance 0.

The JAX gateway runs Pallas in interpret mode, the port ``device="cpu"``
(the kernels' plain torch versions), both with ``autotune=False`` and
the modeled ``decode_cost`` of the reference cases, so span intervals on
the simulated clock are equal float for float.
"""

from __future__ import annotations

import importlib
import json
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
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
        pc=mod("core.product_code"), gw=mod("gateway"), gwm=mod("gateway.gateway"),
        wl=mod("gateway.workload"), obs=mod("obs"), sc=mod("scenario"),
        net=mod("storage.netmodel"), kw=kw,
    )


SIDES = {
    "jax": _side("repro", {"interpret": True, "autotune": False}),
    "torch": _side("repro_torch", {"device": "cpu", "autotune": False}),
}


def both(fn, *args, **kw):
    """``fn(side, ...)`` on both packages -> (jax result, torch result)."""
    return fn(SIDES["jax"], *args, **kw), fn(SIDES["torch"], *args, **kw)


def _strip(spans):
    return [(s.name, s.start, s.end, s.track, s.trace_id, s.span_id, s.parent_id,
             tuple(sorted(s.attrs.items()))) for s in spans]


# ---------------------------------------------------------------------------
# streaming estimators
# ---------------------------------------------------------------------------

def _p2(s, dist, q):
    rng = np.random.default_rng(7)
    xs = {
        "uniform": lambda: rng.uniform(0.001, 1.0, 20000),
        "lognormal": lambda: rng.lognormal(-3.0, 1.0, 20000),
        "exponential": lambda: rng.exponential(0.05, 20000),
    }[dist]()
    est = s.obs.P2Quantile(q)
    for x in xs:
        est.observe(float(x))
    return est.count, est.value, float(np.quantile(xs, q))


@pytest.mark.parametrize("dist", ["uniform", "lognormal", "exponential"])
@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_p2_quantile_equal_and_tracks_exact(dist, q):
    ref, port = both(_p2, dist, q)
    assert port == ref
    count, value, exact = port
    assert count == 20000 and abs(value - exact) / exact < 0.15


def _p2_small(s):
    est = s.obs.P2Quantile(0.5)
    for x in (3.0, 1.0, 2.0):
        est.observe(x)
    with pytest.raises(ValueError):
        s.obs.P2Quantile(1.5)
    return est.value


def test_p2_quantile_exact_below_five_samples():
    assert both(_p2_small) == (2.0, 2.0)


def _hist(s, dist):
    rng = np.random.default_rng(11)
    xs = {
        "uniform": lambda: rng.uniform(0.001, 2.0, 20000),
        "lognormal": lambda: rng.lognormal(-2.0, 1.5, 20000),
    }[dist]()
    h = s.obs.StreamHist()
    for x in xs:
        h.observe(float(x))
    qs = [h.quantile(q) for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)]
    return (qs, [float(np.quantile(xs, q)) for q in (0.1, 0.5, 0.9, 0.99)], h.count, h.min,
            h.max, h.cdf(h.max), h.cdf(h.min - 1e-12), h.growth, list(h.bins))


@pytest.mark.parametrize("dist", ["uniform", "lognormal"])
def test_streamhist_equal_and_relative_error_bound(dist):
    ref, port = both(_hist, dist)
    assert port == ref
    qs, exact, count, lo, hi, cdf_hi, cdf_lo, growth, _bins = port
    for got, want in zip(qs[1:5], exact):
        assert abs(got - want) / want < 2 * (growth - 1.0)
    assert count == 20000 and qs[0] == lo and qs[-1] == hi
    assert cdf_hi == 1.0 and cdf_lo == 0.0


def _merge(s):
    rng = np.random.default_rng(3)
    a, b = rng.exponential(0.1, 5000), rng.exponential(0.3, 5000)
    ha, hb, hu = s.obs.StreamHist(), s.obs.StreamHist(), s.obs.StreamHist()
    for x in a:
        ha.observe(float(x))
        hu.observe(float(x))
    for x in b:
        hb.observe(float(x))
        hu.observe(float(x))
    ha.merge(hb)
    return ha.count == hu.count and ha.bins == hu.bins, ha.quantile(0.9), hu.quantile(0.9)


def test_streamhist_merge_matches_union():
    ref, port = both(_merge)
    assert port == ref
    assert port[0] and port[1] == port[2]


# ---------------------------------------------------------------------------
# bounded containers + registry
# ---------------------------------------------------------------------------

def _bounded(s):
    bs = s.obs.BoundedSamples(cap=64)
    xs = np.random.default_rng(5).uniform(0.0, 10.0, 100_000)
    for x in xs:
        bs.append(float(x))
    log = s.obs.BoundedLog(cap=16)
    for i in range(1000):
        log.append((i, i * 2))
    return (len(bs), bs.resident(), list(bs), bs.mean, bs.max, bs.min, bool(bs),
            bool(s.obs.BoundedSamples()), len(log), log.resident(), list(log))


def test_bounded_samples_and_log_equal():
    ref, port = both(_bounded)
    assert port == ref
    assert port[:2] == (100_000, 64) and port[6:10] == (True, False, 1000, 16)
    assert port[10][0] == (984, 1968) and port[10][-1] == (999, 1998)


def _registry(s):
    m = s.obs.MetricsRegistry()
    for _ in range(50_000):
        m.counter("requests", tenant="a").inc()
        m.histogram("latency", kind="get", tenant="a").observe(0.01)
        m.histogram("latency", kind="get", tenant="b").observe(0.5)
    before = m.resident_samples()
    m.histogram("latency", kind="get", tenant="a").observe(0.01)
    merged = m.merged_histogram("latency", kind="get")
    snap = m.snapshot()
    return (m.counter_total("requests"), before, m.resident_samples(), merged.count,
            merged.quantile(0.25), snap["counters"], sorted(snap["histograms"]))


def test_metrics_registry_bounded_and_queryable():
    ref, port = both(_registry)
    assert port == ref
    total, before, after, count, q25, counters, hists = port
    assert total == 50_000 and before == after and count == 100_001
    assert q25 == pytest.approx(0.01, rel=0.2)
    assert counters["requests{tenant=a}"] == 50_000
    assert "latency{kind=get,tenant=a}" in hists


# ---------------------------------------------------------------------------
# tracer: sampling policies + bounded ring
# ---------------------------------------------------------------------------

def _one_trace(tr, latency: float) -> int:
    tid = tr.begin_trace()
    tr.span("fetch", 0.0, latency / 2, tid, tid)
    tr.root_span("request", 0.0, latency, tid)
    tr.end_trace(tid, latency=latency)
    return tid


def _sampling(s):
    out = []
    for policy, lats in (("head:3", [0.01] * 10), ("tail:0.1", [0.01, 0.5, 0.02, 0.2]),
                         ("head:1,tail:0.1", [0.01, 0.02, 0.5])):
        tr = s.obs.Tracer(sample=policy)
        ids = [_one_trace(tr, lat) for lat in lats]
        out.append((tr.traces_kept, tr.traces_dropped, sorted(tr.trace_ids()), ids))
    for bad in ("p50", ""):
        with pytest.raises(ValueError):
            s.obs.Tracer(sample=bad)
    ring = s.obs.Tracer(sample="always", capacity=100)
    for _ in range(200):
        _one_trace(ring, 0.01)
    out.append((ring.resident(), ring.stats()))
    tr = s.obs.Tracer()
    tid = tr.begin_trace()
    tr.end_trace(tid, latency=0.0)
    out.append((tr.span("late", 0.0, 1.0, tid, tid), tr.span("bogus", 0.0, 1.0, 999999),
                s.obs.NULL_TRACER.begin_trace(), s.obs.NULL_TRACER.enabled))
    return out


def test_tracer_sampling_ring_and_drops_equal():
    ref, port = both(_sampling)
    assert port == ref
    head, tail, combo, (resident, stats), drops = port
    assert head[:2] == (3, 7) and tail[0] == 2 and set(tail[2]) == {tail[3][1], tail[3][3]}
    assert combo[0] == 2
    assert resident <= 100 and stats["spans_resident"] <= 100
    assert drops == (0, 0, 0, False)


# ---------------------------------------------------------------------------
# gateway traces: parenting/ordering invariants + critical path
# ---------------------------------------------------------------------------

def _traced_gateway_run(s):
    code = s.pc.CoreCode(9, 6, 3)
    cfg = s.gw.GatewayConfig(batch_window=0.02, decode_cost=0.002, repair_on_failure=True,
                             repair_delay=0.05, background_share=0.5, tracing=True, **s.kw)
    gw = s.gw.ObjectGateway(code, s.net.ClusterProfile.network_critical(), 60, cfg)
    rng = np.random.default_rng(9)
    gw.load_objects(rng.integers(0, 256, (12, code.k, 2048), dtype=np.uint8))
    reqs = s.gw.generate_requests(
        s.gw.WorkloadConfig(num_objects=12, num_requests=200, arrival_rate=500.0, seed=5))
    victim = gw.store.node_of(("g0", 0, 0))
    report = gw.serve(reqs, [s.wl.FailureEvent(time=0.02, node=victim)])
    return gw, report


@pytest.fixture(scope="module")
def traced():
    return both(_traced_gateway_run)


def test_gateway_spans_equal_the_reference(traced):
    (gj, rj), (gt, rt) = traced
    assert _strip(gt.tracer.spans) == _strip(gj.tracer.spans)
    assert gt.tracer.stats() == gj.tracer.stats()
    assert [(r.time, r.latency, r.degraded) for r in rt.records] == [
        (r.time, r.latency, r.degraded) for r in rj.records]


def test_gateway_span_parenting_and_ordering(traced):
    _gj, (gw, report) = traced
    tr = gw.tracer
    assert tr.traces_kept > 0
    request_roots = 0
    for tid in tr.trace_ids():
        spans = tr.trace(tid)
        by_id = {sp.span_id: sp for sp in spans}
        roots = [sp for sp in spans if sp.parent_id is None]
        assert len(roots) == 1 and roots[0].span_id == tid
        root = roots[0]
        request_roots += root.name == "request"
        for sp in spans:
            assert sp.end >= sp.start
            if sp.parent_id is not None:
                parent = by_id[sp.parent_id]
                assert parent.start <= sp.start + 1e-9 and sp.end <= parent.end + 1e-9
        for d in (sp for sp in spans if sp.name == "decode"):
            assert d.attrs["op_ready"] <= d.attrs["ready"] + 1e-9 <= d.start + 2e-9
        for f in (sp for sp in spans if sp.name == "fetch"):
            assert f.end <= root.end + 1e-9
    assert request_roots == len(report.completed)


def _critical(s, gw):
    out = []
    for tid in gw.tracer.trace_ids():
        spans = gw.tracer.trace(tid)
        root = next((sp for sp in spans if sp.name == "request"), None)
        if root is None:
            continue
        bd = s.obs.critical_path(spans)
        out.append((dict(bd.stages), bd.latency, bd.gated_by, bool(root.attrs.get("degraded"))))
    return out, s.obs.stage_shares(gw.tracer), s.obs.launch_amortization(gw.tracer)


def test_gateway_critical_path_equal_and_additive(traced):
    ref = _critical(SIDES["jax"], traced[0][0])
    port = _critical(SIDES["torch"], traced[1][0])
    assert port == ref
    paths, shares, amort = port
    stages = set(SIDES["torch"].obs.STAGES)
    assert set(SIDES["jax"].obs.STAGES) == stages
    degraded = 0
    for bd_stages, latency, gated_by, was_degraded in paths:
        assert set(bd_stages) == stages and all(v >= 0.0 for v in bd_stages.values())
        assert sum(bd_stages.values()) == pytest.approx(latency, abs=1e-12)
        if was_degraded:
            degraded += 1
            assert gated_by in ("decode", "fetch")
    assert degraded > 0 and shares["traces"] > 0
    assert sum(shares["shares"].values()) == pytest.approx(1.0, abs=1e-9)
    assert amort["launches"] > 0 and amort["ops_per_launch"] >= 1.0


def test_gateway_repair_trace_emitted(traced):
    _gj, (gw, report) = traced
    assert report.repair_reports
    names = {sp.name for sp in gw.tracer.spans}
    assert {"repair.run", "repair.fetch", "repair.group", "repair.heal"} <= names
    for run in (sp for sp in gw.tracer.spans if sp.name == "repair.run"):
        assert [sp for sp in gw.tracer.trace(run.trace_id) if sp.span_id != run.span_id]


def test_gateway_metrics_surface_the_same_gauges(traced):
    (_gj, rj), (_gt, rt) = traced
    snap, ref = rt.metrics.snapshot(), rj.metrics.snapshot()
    assert sorted(snap["gauges"]) == sorted(ref["gauges"])
    assert snap["counters"] == ref["counters"]
    for key in ("jit_retraces{}", "jit_entries{}", "autotune_memory_hits{}",
                "autotune_disk_hits{}", "autotune_sweeps{}", "traces_kept{}"):
        assert key in snap["gauges"]


# ---------------------------------------------------------------------------
# observation-only contract over the scenario engine
# ---------------------------------------------------------------------------

def _fingerprint_run(s, **extra_kw):
    code = s.pc.CoreCode(9, 6, 3)
    setup = s.sc.correlated_surge_setup(code, num_requests=120)
    cfg = s.gw.GatewayConfig(record_payloads=True, **setup["gateway_kwargs"], **extra_kw,
                             **s.kw)
    gw = s.gw.ObjectGateway(code, s.net.ClusterProfile.network_critical(),
                            setup["num_nodes"], cfg)
    rng = np.random.default_rng(setup["seed"])
    gw.load_objects(rng.integers(0, 256, (setup["num_objects"], code.k, setup["block_bytes"]),
                                 dtype=np.uint8))
    return s.sc.run_scenario(gw, setup["trace"], setup["workload"])


TRACING = {"off": {}, "on": {"tracing": True},
           "sampled": {"tracing": True, "trace_sample": "head:5,tail:0.1"}}


@pytest.mark.parametrize("mode", sorted(TRACING))
def test_tracing_is_observation_only_and_equal(mode):
    fps = [s.sc.deterministic_fingerprint(res)
           for s, res in zip(SIDES.values(), both(_fingerprint_run, **TRACING[mode]))]
    assert fps[1] == fps[0]
    if mode != "off":
        base = SIDES["torch"].sc.deterministic_fingerprint(_fingerprint_run(SIDES["torch"]))
        assert fps[1] == base


def _streaming(s):
    full = _fingerprint_run(s).report
    stream = _fingerprint_run(s, record_requests=False).report
    return (len(stream.records), stream.resident_samples(), full.resident_samples(),
            full.latency_percentile(99), stream.latency_percentile(99), full.throughput,
            stream.throughput, len(stream.recent), s.gwm.RECENT_CAP)


def test_streaming_mode_bounded_and_aggregates_agree():
    ref, port = both(_streaming)
    assert port == ref
    n, resident, full_resident, exact_p99, sketch_p99, full_tp, stream_tp, recent, cap = port
    assert n == 0 and resident <= full_resident and resident < 10_000
    assert sketch_p99 == pytest.approx(exact_p99, rel=0.25)
    assert stream_tp == pytest.approx(full_tp, rel=1e-6) and recent <= cap


# ---------------------------------------------------------------------------
# chrome-tracing export + validation
# ---------------------------------------------------------------------------

def test_chrome_export_equal_and_round_trips(traced, tmp_path):
    docs = {}
    for (side, s), (gw, _rep) in zip(SIDES.items(), traced):
        path = tmp_path / f"{side}.json"
        doc = s.obs.write_chrome_trace(str(path), gw.tracer.spans)
        assert s.obs.validate_chrome_trace(doc) == len(doc["traceEvents"])
        docs[side] = json.loads(path.read_text())
    assert docs["torch"] == docs["jax"]
    reloaded = docs["torch"]
    groups = {ev["args"]["name"] for ev in reloaded["traceEvents"]
              if ev["ph"] == "M" and ev["name"] == "process_name"}
    assert {"tenant", "engine", "fabric", "repair"} <= groups
    for ev in reloaded["traceEvents"]:
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
        elif ev["ph"] == "i":
            assert ev["s"] == "t"


BAD_DOCS = [
    [],
    {},
    {"traceEvents": [{"ph": "X"}]},
    {"traceEvents": [{"name": "x", "ph": "Z", "pid": 1, "tid": 1}]},
    {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": -1}]},
    {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": 0}]},
]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_chrome_validator_rejects_malformed(side):
    obs = SIDES[side].obs
    assert obs.validate_chrome_trace(obs.to_chrome_trace([])) == 0
    for doc in BAD_DOCS:
        with pytest.raises(ValueError):
            obs.validate_chrome_trace(doc)
