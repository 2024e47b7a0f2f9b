"""The port's write dataplane against the JAX package's: the cases of
tests/test_writes.py (the ragged ENCODE entries against host oracles,
the stripe sealer, PUT-path physics and admission, deletes, sync vs
ragged write paths, sealed stripes under failure, churn consistency
over a fault trace) run on both packages and their results compared,
tolerance 0.

Where the reference passes ``interpret=True`` the port passes
``device="cpu"`` (the kernels' plain torch versions); both gateways run
with ``autotune=False`` and the modeled ``decode_cost`` of the reference
cases.
"""

from __future__ import annotations

import importlib
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
        pc=mod("core.product_code"), gw=mod("gateway"), wl=mod("gateway.workload"),
        rs=mod("coding.rs"), gf=mod("coding.gf256"), ops=mod("kernels.ops"),
        rdk=mod("kernels.ragged_decode"), gfk=mod("kernels.gf256_matmul"),
        engine=mod("scenario.engine"), trace=mod("scenario.trace"),
        net=mod("storage.netmodel"), kw=kw,
    )


SIDES = {
    "jax": _side("repro", {"interpret": True, "autotune": False}),
    "torch": _side("repro_torch", {"device": "cpu", "autotune": False}),
}


def both(fn, *args, **kw):
    """``fn(side, ...)`` on both packages -> (jax result, torch result)."""
    return fn(SIDES["jax"], *args, **kw), fn(SIDES["torch"], *args, **kw)


def _gateway(s, num_nodes=60, q=2048, num_objects=12, **cfg_kw):
    code = s.pc.CoreCode(9, 6, 3)
    gw = s.gw.ObjectGateway(code, s.net.ClusterProfile.network_critical(), num_nodes,
                            s.gw.GatewayConfig(**cfg_kw, **s.kw))
    rng = np.random.default_rng(9)
    gw.load_objects(rng.integers(0, 256, (num_objects, code.k, q), dtype=np.uint8))
    return gw


def _records(rep):
    return [(r.time, r.object_id, r.kind, r.latency, r.degraded, r.rejected, r.bytes_read,
             r.tenant, r.payload_digest) for r in rep.records]


def _run_op(s, name, *args):
    """A ragged ENCODE entry on the side's own terms: numpy in, numpy out."""
    fn = getattr(s.ops, name)
    if s is SIDES["jax"]:
        return np.asarray(fn(*args, interpret=True))
    return fn(*[torch.from_numpy(a) for a in args]).numpy()


# ---------------------------------------------------------------------------
# kernel level: the ragged ENCODE entries match host oracles
# ---------------------------------------------------------------------------

def _gf_encode(s):
    n, k, tn = 9, 6, 256
    rng = np.random.default_rng(3)
    pmat = s.rs.parity_matrix(n, k)
    c = s.rdk.CHUNK_SMALL
    data = rng.integers(0, 256, (c, k, tn), dtype=np.uint8)
    mc = np.stack([s.gfk.expand_coeff_bitplanes(pmat[i % (n - k)][None, :])[0]
                   for i in range(c)])
    out = _run_op(s, "gf256_ragged_encode", mc, data)
    want = np.stack([s.gf.np_matmul(pmat[i % (n - k)][None, :], data[i])[0] for i in range(c)])
    return out, want


def test_ragged_gf256_encode_matches_parity_oracle():
    (ref, ref_want), (port, want) = both(_gf_encode)
    assert np.array_equal(port, ref) and np.array_equal(want, ref_want)
    assert np.array_equal(port, want)


def _xor_encode(s):
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (s.rdk.CHUNK_SMALL, 5, 128), dtype=np.uint8)
    return _run_op(s, "xor_ragged_encode", data), np.bitwise_xor.reduce(data, axis=1)


def test_ragged_xor_encode_matches_fold_oracle():
    (ref, _), (port, want) = both(_xor_encode)
    assert np.array_equal(port, ref) and np.array_equal(port, want)


# ---------------------------------------------------------------------------
# sealer unit behavior
# ---------------------------------------------------------------------------

def _ext(exts):
    return [(e.small_id, e.offset, e.length) for e in exts]


def _sealer(s):
    sealer = s.gw.StripeSealer(k=2, q=64)
    first = sealer.append(("a",), np.arange(100, dtype=np.uint8), "t")
    sealed = [(seq, row.tobytes(), row.shape, _ext(exts))
              for seq, row, exts in sealer.append(("b",), np.full(60, 7, np.uint8), "t")]
    pending = (sealer.pending_extents, sealer.pending_bytes)
    flushed = [(seq, row.tobytes(), _ext(exts)) for seq, row, exts in sealer.flush()]
    with pytest.raises(ValueError):
        sealer.append(("c",), np.zeros(129, np.uint8), "t")
    return first, sealed, pending, flushed


def test_sealer_extents_never_span_rows_and_flush_pads():
    ref, port = both(_sealer)
    assert port == ref
    first, sealed, pending, flushed = port
    assert first == [] and len(sealed) == 1
    seq, raw, shape, exts = sealed[0]
    assert seq == 0 and shape == (2, 64) and [e[0] for e in exts] == [("a",)]
    assert not any(raw[100:])
    assert pending == (1, 60)
    assert flushed[0][0] == 1 and flushed[0][2][0][1:] == (0, 60)


# ---------------------------------------------------------------------------
# PUT-path physics: billed encode, transfer causality, admission
# ---------------------------------------------------------------------------

def _put_billed(s):
    gw = _gateway(s, encode_cost=0.004, decode_cost=0.002)
    reqs = [s.wl.Request(time=0.001 * (i + 1), object_id=i % 6, kind="put") for i in range(6)]
    rep = gw.serve(reqs)
    return (_records(rep), gw.coalescer.stats.encode_calls,
            rep.metrics.gauge("encode_launches").value)


def test_put_latency_includes_billed_encode_launches():
    ref, port = both(_put_billed)
    assert port == ref
    records, calls, launches = port
    puts = [r for r in records if r[2] == "put"]
    assert len(puts) == 6 and all(r[3] is not None and r[3] > 0.004 for r in puts)
    assert calls > 0 and launches > 0


def _put_pool(s):
    gw = _gateway(s, encode_cost=0.05, decode_cost=0.002, num_engines=1)
    free0 = list(gw._pool.free)
    rep = gw.serve([s.wl.Request(time=0.001, object_id=0, kind="put")])
    return _records(rep), free0, list(gw._pool.free)


def test_put_encode_rides_the_shared_engine_pool():
    ref, port = both(_put_pool)
    assert port == ref
    records, free0, free1 = port
    assert records[0][3] > 0.05 and max(free1) > max(free0)


def _put_admission(s):
    gw = _gateway(s, decode_cost=0.002, admission="reject",
                  tenant_slo_p99={"foreground": 1e-6})
    reqs = [s.wl.Request(time=0.001 * (i + 1), object_id=i % 6, kind="put") for i in range(4)]
    rep = gw.serve(reqs)
    return (_records(rep), dict(rep.put_rejections),
            rep.metrics.counter("rejected_requests", tenant="foreground").value)


def test_put_admission_rejects_and_counts_per_tenant():
    ref, port = both(_put_admission)
    assert port == ref
    records, rejections, counted = port
    assert rejections.get("foreground") == 4 and counted == 4
    assert all(r[5] and r[3] is None for r in records)


def _write_pressure(s):
    gw = _gateway(s, decode_cost=0.002)
    gid, row = gw._objects[0]
    plan = gw.planner.plan(gid, row, at=0.0)
    base = gw._estimate_service_time(plan, 0.0, "foreground")
    gw._put_inflight["foreground"] = [(5.0, 1e7)]
    return base, gw._estimate_service_time(plan, 0.0, "foreground")


def test_write_pressure_feeds_get_admission_estimate():
    ref, port = both(_write_pressure)
    assert port == ref
    assert port[1] > port[0]


# ---------------------------------------------------------------------------
# deletes
# ---------------------------------------------------------------------------

def _deletes(s):
    gw = _gateway(s, decode_cost=0.002)
    kinds = (("delete", 0.001), ("get", 0.002), ("put", 0.003), ("get", 0.010),
             ("delete", 0.011), ("delete", 0.012))
    rep = gw.serve([s.wl.Request(time=t, object_id=0, kind=k) for k, t in kinds])
    return _records(rep), gw.audit_parity()


def test_delete_tombstones_and_put_resurrects():
    ref, port = both(_deletes)
    assert port == ref
    records, audit = port
    by = {}
    for r in records:
        by.setdefault(r[2], []).append(r[3])
    assert by["delete"] == [0.0, 0.0, None]
    assert by["get"][0] is None and by["get"][1] is not None
    assert audit["stale_blocks"] == 0


# ---------------------------------------------------------------------------
# sync-vs-ragged write paths: identical stored state
# ---------------------------------------------------------------------------

def _write_paths(s, mode):
    reqs, t = [], 0.001
    for i in range(8):
        reqs.append(s.wl.Request(time=t, object_id=i % 5, kind="put"))
        t += 0.0005
    for i in range(6):
        reqs.append(s.wl.Request(time=t, object_id=200 + i, kind="put", nbytes=4000))
        t += 0.0005
    gw = _gateway(s, decode_cost=0.002, write_coalesce=mode, batch_window=0.01)
    gw.serve(list(reqs))
    gw.seal_flush(t)
    return (gw.audit_parity(), gw.audit_sealed_stripes(),
            {key: blk.tobytes() for key, blk in gw.store.blocks.items()})


@pytest.mark.parametrize("mode", ["ragged", "sync"])
def test_write_paths_store_the_reference_bytes(mode):
    ref, port = both(_write_paths, mode)
    assert port == ref
    assert port[0]["stale_blocks"] == 0 and port[1]["extents_wrong"] == 0


def test_sync_and_ragged_write_paths_store_identical_bytes():
    s = SIDES["torch"]
    assert _write_paths(s, "ragged")[2] == _write_paths(s, "sync")[2]


# ---------------------------------------------------------------------------
# sealed stripes decode through degraded paths
# ---------------------------------------------------------------------------

def _sealed_degraded(s):
    gw = _gateway(s, decode_cost=0.002, batch_window=0.01)
    t, reqs = 0.001, []
    for i in range(40):
        reqs.append(s.wl.Request(time=t, object_id=1000 + i, kind="put", nbytes=3000))
        t += 0.0004
    gw.serve(reqs)
    gw.seal_flush(t)
    clean = gw.audit_sealed_stripes()
    gw.store.fail_nodes([gw.store.node_of(("w0", 0, 0))])
    return gw._seal_group_seq, clean, gw.audit_sealed_stripes()


def test_sealed_small_puts_survive_node_failure_degraded():
    ref, port = both(_sealed_degraded)
    assert port == ref
    seq, clean, after = port
    assert seq >= 1 and clean["extents_checked"] == 40 and clean["extents_wrong"] == 0
    assert after["rows_degraded"] >= 1
    assert after["extents_wrong"] == 0 and after["rows_unreadable"] == 0


# ---------------------------------------------------------------------------
# churn consistency: faulted trace vs clean oracle + replay identity
# ---------------------------------------------------------------------------

def _run_churn(s, faulted=True):
    code = s.pc.CoreCode(9, 6, 3)
    tr = s.trace
    trace = tr.rack_failure(tr.ScenarioTrace(num_nodes=20, nodes_per_rack=code.n - code.k),
                            0.05, rack=1, downtime=0.6)
    trace = tr.ScenarioTrace(
        num_nodes=20, nodes_per_rack=code.n - code.k,
        events=tuple(sorted(list(trace.events) + [tr.CorruptionEvent(time=0.12, node=14,
                                                                     count=2)],
                            key=lambda e: e.time)),
        surges=trace.surges,
    )
    wl = s.wl.WorkloadConfig(num_objects=24, num_requests=160, arrival_rate=300.0, zipf_s=0.6,
                             put_fraction=0.35, delete_fraction=0.05, small_put_fraction=0.3,
                             small_put_bytes=3000, seed=11)
    gw = s.gw.ObjectGateway(
        code, s.net.ClusterProfile.network_critical(), trace.num_nodes,
        s.gw.GatewayConfig(batch_window=0.01, decode_cost=0.002, repair_on_failure=True,
                           repair_delay=0.05, record_payloads=True, **s.kw),
    )
    rng = np.random.default_rng(9)
    gw.load_objects(rng.integers(0, 256, (wl.num_objects, code.k, 2048), dtype=np.uint8))
    reqs = tr.scenario_requests(wl, trace)
    report = gw.serve(reqs, trace.cluster_events() if faulted else [])
    gw.seal_flush(reqs[-1].time + 1.0)
    res = s.engine.ScenarioResult(report=report, durability=gw.audit_durability(),
                                  trace=trace)
    return (s.engine.deterministic_fingerprint(res), res, gw.audit_parity(),
            gw.audit_sealed_stripes())


@pytest.fixture(scope="module")
def churn():
    return {faulted: both(_run_churn, faulted) for faulted in (True, False)}


@pytest.mark.parametrize("faulted", [True, False], ids=["faulted", "clean"])
def test_churn_runs_equal_the_reference(churn, faulted):
    ref, port = churn[faulted]
    assert port[0] == ref[0]
    assert _records(port[1].report) == _records(ref[1].report)
    assert port[2:] == ref[2:]


def test_churn_consistency_audit_under_within_tolerance_faults(churn):
    fp, faulted, parity, sealed = churn[True][1]
    clean = churn[False][1][1]
    assert faulted.durability["blocks_lost"] == 0

    def digests(res):
        return {(round(r.time, 9), r.object_id): r.payload_digest
                for r in res.report.records if r.kind == "get" and r.latency is not None}

    dx, dc = digests(faulted), digests(clean)
    shared = set(dx) & set(dc)
    assert shared and all(dx[key] == dc[key] for key in shared)
    assert parity["stale_blocks"] == 0
    assert sealed["extents_wrong"] == 0 and sealed["extents_pending"] == 0
    assert _run_churn(SIDES["torch"])[0] == fp


def _encode_signatures(s):
    gw = _gateway(s, decode_cost=0.002, batch_window=0.01)
    t, reqs = 0.001, []
    for i in range(30):
        reqs.append(s.wl.Request(time=t, object_id=i % 12, kind="put"))
        t += 0.0003 if i % 5 else 0.05
    rep = gw.serve(reqs)
    return _records(rep), gw.coalescer.jit_entries_by_kind()


def test_encode_signatures_stay_bounded_per_kind():
    ref, port = both(_encode_signatures)
    assert port[0] == ref[0]
    by_kind = port[1]
    assert by_kind.get("EH", 0) >= 1
    assert all(v <= 2 for k, v in by_kind.items() if k in ("EH", "EV")), by_kind
