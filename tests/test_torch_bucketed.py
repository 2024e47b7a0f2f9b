"""The port's shape-bucketed decode dataplane (``mode="bucketed"``) and
the autotune default against the JAX package, byte for byte (tolerance
0).

The coalescer comparison feeds both packages the same mixed windows (the
generator of tests/test_ragged_decode.py) and requires equal results,
equal LaunchUnits and equal stats counters, all but the measured wall
time. The gateway comparison serves the degraded GET/PUT trace of
tests/test_torch_gateway.py with ``coalesce="bucketed"`` and per-launch
modeled billing on both, ``autotune=False`` (a tuned width would change
only the padding, never the bytes, but is measured per device).
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core.product_code as jpc  # noqa: E402
import repro.gateway as jgw  # noqa: E402
import repro.kernels as jkernels  # noqa: E402
from repro.gateway import coalescer as jco  # noqa: E402
from repro.gateway.planner import DecodeOp as JDecodeOp  # noqa: E402
import repro.storage.netmodel as jnet  # noqa: E402
import repro_torch.core.product_code as tpc  # noqa: E402
import repro_torch.gateway as tgw  # noqa: E402
import repro_torch.kernels as tkernels  # noqa: E402
from repro_torch.gateway import coalescer as tco  # noqa: E402
from repro_torch.gateway.planner import DecodeOp  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
import repro_torch.storage.netmodel as tnet  # noqa: E402

VICTIMS = (("g0", 0, 0), ("g0", 1, 0), ("g1", 0, 2))
_MEASURED = {"compute_time", "encode_compute_time"}
# the port's own counter, which the reference's stats lack: held to the
# bytes of the decode outputs ``execute`` returned instead
_PORT_ONLY = {"decode_out_bytes"}


def _random_window(rng, n_ops, lengths=(100, 512, 1000, 4096)):
    """Mixed window as in tests/test_ragged_decode.py: V ops over 3 or 5
    sources, H ops with 1-3 targets over 6 sources, ragged lengths."""
    ours, theirs, store = [], [], {}
    for i in range(n_ops):
        kind = ["V", "H"][int(rng.integers(0, 2))]
        length = int(rng.choice(lengths))
        if kind == "V":
            kk = int(rng.choice([3, 5]))
            sources = tuple((f"g{i}", r, 0) for r in range(kk))
            args = ("V", f"g{i}", kk, (0,), sources, None)
        else:
            m = int(rng.integers(1, 4))
            sources = tuple((f"g{i}", 0, c) for c in range(6))
            coeffs = rng.integers(0, 256, (m, 6), dtype=np.uint8)
            args = ("H", f"g{i}", 0, tuple(range(m)), sources, coeffs)
        for s in sources:
            store[s] = rng.integers(0, 256, length, dtype=np.uint8)
        ours.append(DecodeOp(*args))
        theirs.append(JDecodeOp(*args))
    return ours, theirs, store


def _stats(co):
    return {
        f.name: getattr(co.stats, f.name)
        for f in dataclasses.fields(co.stats)
        if f.name not in _MEASURED | _PORT_ONLY
    }


def _units(units):
    return [(u.op_indices, u.kind, u.launch_id, u.fraction, u.tiles) for u in units]


def _assert_same_windows(windows):
    ours = tco.DecodeCoalescer(device="cpu", mode=tco.BUCKETED, autotune_kernels=False)
    theirs = jco.DecodeCoalescer(interpret=True, mode=jco.BUCKETED, autotune_kernels=False)
    out_bytes = 0
    for w_ours, w_theirs, store in windows:
        fetch = lambda key: store[key]  # noqa: E731
        res_o, units_o = ours.execute(w_ours, fetch)
        res_t, units_t = theirs.execute(w_theirs, fetch)
        out_bytes += sum(a.nbytes for r in res_o for a in r.values())
        assert len(res_o) == len(res_t) == len(w_ours)
        for a, b in zip(res_o, res_t):
            assert set(a) == set(b)
            for col in a:
                np.testing.assert_array_equal(a[col], b[col])
        assert _units(units_o) == _units(units_t)
    assert _stats(ours) == _stats(theirs)
    assert ours.stats.decode_out_bytes == out_bytes
    assert ours.stats.padded_byte_ratio == theirs.stats.padded_byte_ratio
    assert ours.jit_entries_by_kind() == theirs.jit_entries_by_kind()
    assert ours.stats.compute_time > 0
    return ours


@pytest.mark.parametrize("seed", range(4))
def test_bucketed_coalescer_matches_jax_on_mixed_windows(seed):
    rng = np.random.default_rng(seed)
    windows = [_random_window(rng, int(rng.integers(1, 16))) for _ in range(2)]
    co = _assert_same_windows(windows)
    assert co.stats.decode_ops == sum(len(w[0]) for w in windows)


def test_bucketed_top_rung_overflow_window_matches_jax():
    """A window beyond the top ladder rung splits into a 256-stripe
    launch and a 10-padded-to-16 one, on both packages."""
    rng = np.random.default_rng(99)
    ours, theirs, store = [], [], {}
    for i in range(tco.PAD_LADDER[-1] + 10):
        sources = tuple((f"g{i}", r, 0) for r in range(3))
        for s in sources:
            store[s] = rng.integers(0, 256, 64, dtype=np.uint8)
        ours.append(DecodeOp("V", f"g{i}", 3, (0,), sources, None))
        theirs.append(JDecodeOp("V", f"g{i}", 3, (0,), sources, None))
    co = _assert_same_windows([(ours, theirs, store)])
    assert co.stats.decode_calls == 2
    assert co.stats.padded_ops == 6 and co.stats.max_batch == tco.PAD_LADDER[-1]


def test_ladder_identical():
    assert tco.PAD_LADDER == jco.PAD_LADDER
    for b in (1, 2, 3, 5, 17, 255, 256):
        assert tco.ladder_rung(b) == jco.ladder_rung(b)
    for b in (0, tco.PAD_LADDER[-1] + 1):
        with pytest.raises(ValueError):
            tco.ladder_rung(b)


def test_public_names_identical():
    assert set(tgw.__all__) == set(jgw.__all__)
    assert set(tkernels.__all__) == set(jkernels.__all__)
    assert len(tkernels.__all__) == 12
    assert tgw.GatewayConfig().autotune is jgw.GatewayConfig().autotune is True
    assert tco.DecodeCoalescer(device="cpu").autotune_kernels is True


# ---------------------------------------------------------------------------
# the gateway with coalesce="bucketed"
# ---------------------------------------------------------------------------

def _serve(pc, gw, net, trace_seed=4, **cfg):
    g = gw.ObjectGateway(
        pc.CoreCode(9, 6, 3), net.ClusterProfile.network_critical(), 60,
        gw.GatewayConfig(batch_window=0.01, record_payloads=True, encode_cost=2e-4, **cfg),
    )
    g.load_objects(np.random.default_rng(9).integers(0, 256, (12, 6, 2048), dtype=np.uint8))
    reqs = gw.generate_requests(
        gw.WorkloadConfig(num_objects=12, num_requests=150, arrival_rate=3000.0,
                          put_fraction=0.15, seed=trace_seed)
    )
    failures = [
        gw.FailureEvent(time=0.005 + 0.01 * i, node=g.store.node_of(key))
        for i, key in enumerate(VICTIMS)
    ]
    return g, g.serve(reqs, failures)


def _records(rep):
    return [(r.time, r.object_id, r.kind, r.degraded, r.payload_digest, r.latency)
            for r in rep.records]


def _digests(rep):
    return [(r.time, r.object_id, r.kind, r.degraded, r.payload_digest) for r in rep.records]


@pytest.fixture(scope="module")
def bucketed():
    billing = dict(coalesce="bucketed", decode_cost=1e-4, autotune=False)
    return {
        "jax": _serve(jpc, jgw, jnet, interpret=True, **billing),
        "torch": _serve(tpc, tgw, tnet, device="cpu", **billing),
    }


def test_bucketed_gateway_records_identical(bucketed):
    (_gj, rj), (_gt, rt) = bucketed["jax"], bucketed["torch"]
    assert len(rt.records) == 150
    assert _records(rt) == _records(rj)
    gets = [r for r in rt.records if r.kind == "get"]
    assert rt.metrics.counter_total("verified_gets") == len(gets)
    assert any(r.degraded for r in gets)


def test_bucketed_gateway_counters_and_audit_identical(bucketed):
    (gj, rj), (gt, rt) = bucketed["jax"], bucketed["torch"]
    for name in ("decode_launches", "jit_cache_entries", "padded_byte_ratio",
                 "launches_per_window"):
        assert getattr(rt, name) == getattr(rj, name), name
    sj, st = gj.coalescer.stats, gt.coalescer.stats
    for name in ("ops_by_kind", "sources_by_kind", "encode_calls", "encode_ops",
                 "decode_calls", "decode_ops", "padded_ops", "staged_bytes",
                 "padded_bytes", "batch_hist", "jit_retraces"):
        assert getattr(st, name) == getattr(sj, name), name
    assert st.ops_by_kind.get("H", 0) > 0 and st.ops_by_kind.get("V", 0) > 0
    assert gt.coalescer.jit_entries_by_kind() == gj.coalescer.jit_entries_by_kind()
    audit = gt.audit_parity()
    assert audit == gj.audit_parity() and audit["stale_blocks"] == 0
    for name in ("autotune_memory_hits", "autotune_disk_hits", "autotune_sweeps"):
        assert f"{name}{{}}" in rt.metrics.snapshot()["gauges"], name


def test_ragged_and_bucketed_serve_identical_bytes_in_the_port(bucketed):
    """coalesce="ragged" vs "bucketed" changes when decodes are billed,
    never what is served (twin of tests/test_ragged_decode.py)."""
    _g, ragged = _serve(tpc, tgw, tnet, device="cpu", autotune=False,
                        decode_cost_per_tile=1e-5)
    _gt, buck = bucketed["torch"]
    assert _digests(ragged) == _digests(buck)
    assert any(r.degraded for r in ragged.records)


def test_autotuned_bucketed_serve_matches_jax_payloads(bucketed, tmp_path, monkeypatch):
    """With the default autotune=True the port sweeps on first use (the
    gauge says so) and still serves the JAX package's bytes."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    saved = dict(autotune._CACHE)
    autotune._CACHE.clear()
    try:
        sweeps = autotune.cache_stats()["sweeps"]
        gt, rt = _serve(tpc, tgw, tnet, device="cpu", coalesce="bucketed", decode_cost=1e-4)
    finally:
        autotune._CACHE.clear()
        autotune._CACHE.update(saved)
    assert gt.config.autotune is True
    assert autotune.cache_stats()["sweeps"] > sweeps
    assert rt.metrics.gauge("autotune_sweeps").value > 0
    assert set(gt.coalescer._tuned) == {"bucketed:H", "bucketed:V", "ragged:EH", "ragged:EV"}
    _gj, rj = bucketed["jax"]
    assert _digests(rt) == _digests(rj)
