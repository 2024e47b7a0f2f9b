"""The port's gray-failure plane against the JAX package's: the cases of
tests/test_integrity.py (per-block digests and corruption modes, the
scrubber, fail-slow fabric rates, hedge paths, read/scrub detection and
repair, the gray trace schema) run on both packages and their results
compared, tolerance 0; then the gray-trace property's fingerprints for
seeds 0-7.

The JAX gateway runs Pallas in interpret mode, the port ``device="cpu"``
(the kernels' plain torch versions), both with ``autotune=False``.
Gateway runs bill decode with the modeled ``decode_cost`` (added on both
sides where the reference case measures it), so no outcome reads the
wall clock.
"""

from __future__ import annotations

import importlib
import zlib
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
import torch  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves, and the
    suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _side(pkg: str, kw: dict, codec_kw: dict) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        pc=mod("core.product_code"), gw=mod("gateway"), wl=mod("gateway.workload"),
        planner=mod("gateway.planner"), sc=mod("scenario"), bs=mod("storage.blockstore"),
        net=mod("storage.netmodel"), rep=mod("storage.repair"), kw=kw, codec_kw=codec_kw,
    )


SIDES = {
    "jax": _side("repro", {"interpret": True, "autotune": False}, {}),
    "torch": _side("repro_torch", {"device": "cpu", "autotune": False}, {"device": "cpu"}),
}
MODELED = {"decode_cost": 0.002}


def both(fn, *args, **kw):
    """``fn(side, ...)`` on both packages -> (jax result, torch result)."""
    return fn(SIDES["jax"], *args, **kw), fn(SIDES["torch"], *args, **kw)


def _store(s, num_nodes=30, q=1024, seed=0):
    code = s.pc.CoreCode(9, 6, 3)
    store = s.bs.BlockStore(num_nodes=num_nodes)
    rng = np.random.default_rng(seed)
    objects = rng.integers(0, 256, size=(code.t, code.k, q), dtype=np.uint8)
    store.put_group("g0", np.asarray(s.pc.CoreCodec(code, **s.codec_kw).encode(objects)))
    return code, store


def _gateway(s, num_nodes=60, q=2048, num_objects=12, seed=9, **cfg_kw):
    code = s.pc.CoreCode(9, 6, 3)
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


def _counters(report, *names, **labels):
    return {n: report.metrics.counter_total(n, **labels) for n in names}


# ---------------------------------------------------------------------------
# block store: digests, corruption modes, quarantine
# ---------------------------------------------------------------------------

def _digests_clean(s):
    _code, store = _store(s)
    assert len(store.checksums) == len(store.blocks)
    return {k: (store.checksums[k], store.verify(k), store.checksum_ok(k, store.get(k)))
            for k in store.blocks}


def test_put_records_digest_and_verify_passes_when_clean():
    ref, port = both(_digests_clean)
    assert port == ref
    assert all(ok and good is True for _d, ok, good in port.values())


def _corrupt_modes(s):
    _code, store = _store(s)
    out = []
    for mode, key in (("bitflip", ("g0", 0, 0)), ("torn", ("g0", 0, 1))):
        before = store.checksums[key]
        out.append((store.corrupt_block(key, mode=mode), store.checksums[key] == before,
                    store.verify(key), store.checksum_ok(key, store.get(key)),
                    store.get(key).tobytes()))
    out.append((store.corrupt_block(("g0", 0, 2), mode="erase"),
                store.available(("g0", 0, 2)),
                store.corrupt_block(("g0", 0, 2), mode="bitflip")))
    return out


def test_corrupt_block_modes_break_verify_but_not_checksum():
    ref, port = both(_corrupt_modes)
    assert port == ref
    for hit, stale, ok, good, _raw in port[:2]:
        assert hit and stale and not ok and good is False
    assert port[2] == (True, False, False)


def _corrupt_copy(s):
    _code, store = _store(s)
    key = ("g0", 1, 3)
    held = store.get(key)
    snapshot = held.copy()
    assert store.corrupt_block(key, mode="bitflip")
    return np.array_equal(held, snapshot), store.get(key).tobytes(), snapshot.tobytes()


def test_corrupt_block_writes_a_new_array_not_in_place():
    ref, port = both(_corrupt_copy)
    assert port == ref
    assert port[0] and port[1] != port[2]


def _quarantine(s):
    _code, store = _store(s)
    key, other = ("g0", 2, 4), ("g0", 2, 5)
    node = store.node_of(key)
    store.quarantine(key)
    store.drop_block(other)
    return (store.available(key), store.node_of(key) == node, key in store.checksums,
            store.available(other))


def test_quarantine_keeps_placement_and_digest_drop_block_delegates():
    ref, port = both(_quarantine)
    assert port == ref == (False, True, True, False)


_BYTES = np.random.default_rng(5).integers(0, 256, 4096, dtype=np.uint8)
DIGEST_CASES = {
    "uint8_1d": _BYTES,
    "block_2d": _BYTES.reshape(64, 64),
    "strided": _BYTES.reshape(64, 64)[::3, 1::2],
    "float32": _BYTES.view(np.float32).reshape(32, 32).T,
    "empty": _BYTES[:0],
}


@pytest.mark.parametrize("case", DIGEST_CASES)
def test_digest_hashes_in_place_as_the_reference_hashes_a_copy(case):
    a = DIGEST_CASES[case]
    want = zlib.crc32(np.asarray(a).tobytes())
    assert SIDES["torch"].bs.BlockStore.digest(a) == want
    assert SIDES["jax"].bs.BlockStore.digest(a) == want


def _verify_store(s, q):
    store = s.bs.BlockStore(num_nodes=30)
    store.put_group("g0", np.random.default_rng(11).integers(0, 256, (2, 5, q), dtype=np.uint8))
    return store


def _damage(store, case):
    """Keys in a fixed order, after ``case``'s damage to ``store``."""
    keys = sorted(store.blocks)
    if case in ("bitflip", "torn", "erase"):
        store.corrupt_block(("g0", 0, 1), mode=case)
        store.corrupt_block(("g0", 1, 3), mode=case)
    elif case == "quarantined":
        store.corrupt_block(("g0", 1, 0), mode="torn")
        store.quarantine(("g0", 1, 0))
    elif case == "no_digest":
        store.corrupt_block(("g0", 0, 4), mode="bitflip")
        del store.checksums[("g0", 0, 4)]
    elif case == "mixed":
        store.corrupt_block(("g0", 1, 4), mode="bitflip")
        store.corrupt_block(("g0", 0, 0), mode="torn")
        store.quarantine(("g0", 0, 2))
        keys = keys[::-1] + [("g0", 9, 9)]
    return keys


# path -> (block bytes, CPUs the store sees); the pooled path hashes each
# batch on min(CPUs, blocks) threads once it holds POOL_MIN_BYTES
VERIFY_PATHS = {"inline": (4096, 4), "one_cpu": (2 << 20, 1), "pooled": (2 << 20, 4)}


@pytest.mark.parametrize("impl", ["fold", "zlib"])
@pytest.mark.parametrize("case", ["clean", "bitflip", "torn", "erase", "quarantined",
                                  "no_digest", "mixed"])
@pytest.mark.parametrize("path", VERIFY_PATHS)
def test_verify_many_returns_what_one_key_verify_returns(monkeypatch, path, case, impl):
    """``impl``: the crc32 the host would take, or zlib's as on a host
    without the fold; blocks under ``FOLD_MIN_BYTES`` take zlib's anyway."""
    from repro_torch.obs import MetricsRegistry, host
    from repro_torch.storage import crc32
    from torch.profiler import ProfilerActivity, profile

    q, cpus = VERIFY_PATHS[path]
    bs = SIDES["torch"].bs
    monkeypatch.setattr(bs, "_cpus", lambda: cpus)
    if impl == "zlib":
        monkeypatch.setattr(crc32, "fast_path", lambda: False)
    assert (q * 10 >= bs.POOL_MIN_BYTES) == (path != "inline")
    port, ref = _verify_store(SIDES["torch"], q), _verify_store(SIDES["jax"], q)
    keys, ref_keys = _damage(port, case), _damage(ref, case)
    assert keys == ref_keys
    want = [k for k in keys if not ref.verify(k)]
    assert want == [k for k in keys if not port.verify(k)]
    reg = MetricsRegistry()
    with profile(activities=[ProfilerActivity.CPU]), host.recording(reg, "test.root"):
        got = port.verify_many(keys)
    assert got == want
    assert bool(got) == (case in ("bitflip", "torn", "mixed"))
    hashed = sum(k in port.blocks and k in port.checksums for k in keys)
    pooled = path == "pooled"
    assert reg.counter_total("host_verify_blocks", path="pooled") == hashed * pooled
    assert reg.counter_total("host_verify_blocks", path="inline") == hashed * (not pooled)
    assert reg.counter_total("host_verify_workers", span="test.root") == (
        min(cpus, hashed) if pooled else 1)
    folded = impl == "fold" and crc32.fast_path() and q >= crc32.FOLD_MIN_BYTES
    assert reg.counter_total("host_crc32_bytes", impl="fold") == hashed * q * folded
    assert reg.counter_total("host_crc32_bytes", impl="zlib") == hashed * q * (not folded)


def _repair_corrupt_source(s):
    """A node's disk is lost while a surviving block of one of its
    groups is silently corrupt: the repair's check must catch it."""
    gw = _gateway(s, q=64 * 1024, batch_window=0.01, repair_on_failure=True,
                  repair_delay=0.02, **MODELED)
    lost = gw.store.node_of(("g0", 0, 0))
    bad = next(k for k in sorted(gw.store.blocks)
               if k[0] == "g0" and gw.store.node_of(k) != lost)
    original = {k: blk.copy() for k, blk in gw.store.blocks.items()}
    events = [s.wl.CorruptionEvent(time=0.005, node=gw.store.node_of(bad), blocks=(bad,),
                                   mode="bitflip"),
              s.wl.CapacityLossEvent(time=0.01, node=lost)]
    report = gw.serve([], events)
    return (bad, {k: b.tobytes() for k, b in original.items()},
            {k: np.asarray(b).tobytes() for k, b in gw.store.blocks.items()},
            _counters(report, "corruption_detected", source="repair"),
            gw.audit_durability())


def test_repair_quarantines_and_rebuilds_a_silently_corrupt_source(monkeypatch):
    # four CPUs, so the group's 1.6 MiB check runs on the pool
    monkeypatch.setattr(SIDES["torch"].bs, "_cpus", lambda: 4)
    ref, port = both(_repair_corrupt_source)
    bad, original, blocks, detected, audit = port
    assert blocks == ref[2] == original
    assert detected == ref[3] and detected["corruption_detected"] == 1
    assert audit == ref[4] and audit["missing_blocks"] == 0
    assert ref[0] == bad and blocks[bad] == original[bad]


def _scrub(s):
    _code, store = _store(s)
    store.corrupt_block(("g0", 0, 4), mode="torn")
    scrubber = s.rep.Scrubber(store, blocks_per_run=8)
    return [scrubber.scan(8) for _ in range(len(store.blocks) // 8 + 2)], scrubber.scanned


def test_scrubber_walks_the_store_and_reports_mismatches():
    ref, port = both(_scrub)
    assert port == ref
    assert ("g0", 0, 4) in [k for batch in port[0] for k in batch]


# ---------------------------------------------------------------------------
# fabric model: fail-slow rates
# ---------------------------------------------------------------------------

def _node_rates(s):
    sim = s.net.NetSimulator(s.net.ClusterProfile.network_critical())
    for args, kw in (((3, 0.0), {}), ((3, 1.5), {}), ((3, 0.5), {"direction": "up"})):
        with pytest.raises(ValueError):
            sim.set_node_rate(*args, **kw)
    sim.set_node_rate(3, 0.25, direction="send")
    out = [sim.node_rate(3, "send"), sim.node_rate(3, "recv")]
    sim.set_node_rate(3, 1.0, direction="both")
    return out + [sim.node_rate(3, "send"), dict(sim._node_rate)]


def test_set_node_rate_validation_and_restore():
    ref, port = both(_node_rates)
    assert port == ref == [0.25, 1.0, 1.0, {}]


def _slow_transfers(s):
    prof = s.net.ClusterProfile.network_critical()
    nbytes = 1 << 20
    sim = s.net.NetSimulator(prof)
    healthy = sim.transfer(s.net.Transfer(0, 1, nbytes))
    sim.set_node_rate(2, 0.1)
    slow = sim.transfer(s.net.Transfer(2, 3, nbytes))
    sim = s.net.NetSimulator(prof)
    sim.set_node_rate(5, 0.05)
    slow_in = sim.transfer(s.net.Transfer(5, 1, nbytes))
    healthy_in = sim.transfer(s.net.Transfer(6, 1, nbytes))
    return healthy, slow, slow_in, healthy_in, nbytes / prof.node_bandwidth


def test_slow_transfers_stretch_by_rate_and_leave_the_receiver_free():
    ref, port = both(_slow_transfers)
    assert port == ref
    healthy, slow, slow_in, healthy_in, wire = port
    assert slow == pytest.approx(healthy * 10, rel=1e-6)
    assert slow_in == pytest.approx(20 * wire, rel=1e-6)
    assert healthy_in < 3 * wire and healthy_in < slow_in / 4


# ---------------------------------------------------------------------------
# planner: hedge alternate paths
# ---------------------------------------------------------------------------

def _ops(ops):
    return [(op.kind, tuple(op.sources), tuple(op.targets)) for op in ops]


def _recovery_ops(s):
    code, store = _store(s)
    planner = s.planner.DegradedReadPlanner(store, code)
    out = [_ops(planner.recovery_ops("g0", 0, 0)),
           _ops([planner.recovery_op("g0", 0, 0)])]
    store.drop_block(("g0", 1, 0))
    out.append(_ops(planner.recovery_ops("g0", 0, 0)))
    for c in range(1, code.n - code.k + 1):
        store.drop_block(("g0", 0, c))
    out += [planner.recovery_ops("g0", 0, 0), planner.recovery_op("g0", 0, 0)]
    return out


def test_recovery_ops_orders_vertical_then_horizontal():
    ref, port = both(_recovery_ops)
    assert port == ref
    first, chosen, column_broken, none, nothing = port
    assert [k for k, _s, _t in first] == ["V", "H"] and chosen == first[:1]
    assert len(first[0][1]) == 3 and len(first[1][1]) == 6
    assert [k for k, _s, _t in column_broken] == ["H"]
    assert none == () and nothing is None


# ---------------------------------------------------------------------------
# end to end: read-path detection, tombstones, repair heal
# ---------------------------------------------------------------------------

def _read_detect(s):
    gw = _gateway(s, batch_window=0.01, cache_bytes=4 * 1024 * 1024, repair_on_failure=True,
                  repair_delay=0.02, record_payloads=True, **MODELED)
    gid, row = gw._objects[0]
    bad = (gid, row, 2)
    events = [s.wl.CorruptionEvent(time=0.005, node=gw.store.node_of(bad), blocks=(bad,),
                                   mode="bitflip")]
    report = gw.serve([s.wl.Request(time=0.01 + 0.02 * i, object_id=0) for i in range(3)],
                      events)
    return (_records(report), _counters(report, "corruption_detected", source="read"),
            report.metrics.counter_total("verified_gets"), gw.store.verify(bad),
            gw.audit_durability(), list(report.corruption_latency))


def test_read_detects_silent_corruption_and_serves_correct_bytes():
    ref, port = both(_read_detect)
    assert port == ref
    records, detected, verified, healed, audit, latency = port
    assert all(r[3] is not None for r in records)
    assert records[0][4] and records[0][7] > 0
    assert detected["corruption_detected"] >= 1 and verified == 3
    assert healed and audit["missing_blocks"] == 0
    assert latency and all(x >= 0.0 for x in latency)


def _tombstone_shed(s):
    gw = _gateway(s, batch_window=0.01, cache_bytes=2 * 2048, repair_on_failure=True,
                  repair_delay=0.02, **MODELED)
    gid, row = gw._objects[0]
    bad = (gid, row, 1)
    events = [s.wl.CorruptionEvent(time=0.005, node=gw.store.node_of(bad), blocks=(bad,),
                                   mode="torn")]
    reqs = [s.wl.Request(time=0.01, object_id=0)]
    reqs += [s.wl.Request(time=0.5 + 0.01 * i, object_id=0) for i in range(2)]
    report = gw.serve(reqs, events)
    return _records(report), gw.store.verify(bad), gw.cache.negative_entries


def test_corrupt_then_repaired_block_sheds_its_tombstone():
    ref, port = both(_tombstone_shed)
    assert port == ref
    records, healed, negatives = port
    assert all(r[3] is not None for r in records)
    assert records[0][4] and not records[-1][4] and healed and negatives == 0


def _scrub_detect(s):
    gw = _gateway(s, batch_window=0.01, repair_on_failure=True, repair_delay=0.02,
                  scrub_interval=0.05, scrub_blocks_per_run=256, **MODELED)
    gid, row = gw._objects[0]
    bad = (gid, row, 3)
    events = [s.wl.CorruptionEvent(time=0.01, node=gw.store.node_of(bad), blocks=(bad,),
                                   mode="bitflip")]
    reqs = [s.wl.Request(time=0.02 * (i + 1), object_id=1 + (i % 3)) for i in range(25)]
    report = gw.serve(reqs, events)
    return (_records(report), _counters(report, "corruption_detected", source="scrub"),
            report.metrics.counter_total("scrub_blocks"), list(report.corruption_latency),
            gw.store.verify(bad))


def test_scrub_detects_latent_corruption_without_a_read():
    ref, port = both(_scrub_detect)
    assert port == ref
    _rec, detected, scrubbed, latency, healed = port
    assert detected["corruption_detected"] >= 1 and scrubbed > 0
    assert latency and 0.0 <= max(latency) < 0.5 and healed


def _slow_events(s):
    gw = _gateway(s, batch_window=0.01, **MODELED)
    events = [
        s.wl.SlowNodeEvent(time=0.0, node=7, rate_factor=0.2),
        s.wl.SlowNicEvent(time=0.0, node=8, rate_factor=0.5, direction="recv"),
        s.wl.SlowNodeEvent(time=0.05, node=7, rate_factor=1.0),
    ]
    report = gw.serve([s.wl.Request(time=0.01, object_id=0),
                       s.wl.Request(time=0.1, object_id=1)], events)
    return (_records(report), report.metrics.counter_total("slow_events"),
            gw.sim.node_rate(7, "send"), gw.sim.node_rate(8, "recv"),
            gw.sim.node_rate(8, "send"))


def test_slow_events_drive_the_fabric_rate_and_restore():
    ref, port = both(_slow_events)
    assert port == ref
    assert port[1:] == (3, 1.0, 0.5, 1.0)


# ---------------------------------------------------------------------------
# hedged degraded reads
# ---------------------------------------------------------------------------

HEDGE = ("hedge_launched", "hedge_wins", "hedge_bytes", "hedge_budget_denied",
         "verified_gets")


def _fail_slow_run(s, hedge, budget=1.0):
    gw = _gateway(s, batch_window=0.005, decode_cost=0.0005, hedge=hedge, hedge_budget=budget)
    slow = gw.store.node_of((gw._objects[0][0], gw._objects[0][1], 0))
    events = [s.wl.SlowNodeEvent(time=0.0, node=slow, rate_factor=0.05)]
    report = gw.serve([s.wl.Request(time=0.01 * i, object_id=i % 12) for i in range(120)],
                      events)
    return (_records(report), _counters(report, *HEDGE), report.latency_percentile(99),
            sum(gw._fetch_bytes.values()))


@pytest.fixture(scope="module")
def fail_slow():
    return {(hedge, budget): both(_fail_slow_run, hedge, budget)
            for hedge, budget in ((False, 1.0), (True, 1.0), (True, 0.05), (True, 1e-6))}


@pytest.mark.parametrize("hedge,budget", [(False, 1.0), (True, 1.0), (True, 0.05), (True, 1e-6)])
def test_fail_slow_runs_equal_the_reference(fail_slow, hedge, budget):
    ref, port = fail_slow[(hedge, budget)]
    assert port == ref
    assert all(r[3] is not None for r in port[0])


def test_hedged_reads_beat_unhedged_p99_under_fail_slow(fail_slow):
    base, hedged = fail_slow[(False, 1.0)][1], fail_slow[(True, 1.0)][1]
    c = hedged[1]
    assert c["hedge_launched"] > 0 and c["hedge_wins"] > 0
    assert hedged[2] < base[2] and c["verified_gets"] == len(hedged[0])


def test_hedge_byte_budgets_cap_and_deny(fail_slow):
    _rec, c, _p99, primary = fail_slow[(True, 0.05)][1]
    assert primary > 0 and c["hedge_bytes"] <= 0.05 * primary + 1e-9
    _rec, c, _p99, _primary = fail_slow[(True, 1e-6)][1]
    assert c["hedge_launched"] == 0 and c["hedge_budget_denied"] > 0 and c["hedge_bytes"] == 0


# ---------------------------------------------------------------------------
# trace schema: gray events round-trip + generator tolerance
# ---------------------------------------------------------------------------

def _gray_json(s):
    wl = s.wl
    trace = s.sc.ScenarioTrace(
        num_nodes=12, nodes_per_rack=4,
        events=(
            wl.CorruptionEvent(time=0.1, node=3, blocks=(("g0", 0, 1),), mode="torn"),
            wl.SlowNodeEvent(time=0.2, node=5, rate_factor=0.25),
            wl.SlowNicEvent(time=0.3, node=7, rate_factor=0.5, direction="recv"),
            wl.SlowNodeEvent(time=0.4, node=5, rate_factor=1.0),
        ),
    )
    trace = s.sc.flapping_slow(trace, node=9, start=0.5, period=0.1, count=2, rate_factor=0.1)
    again = s.sc.trace_from_jsonable(trace.to_jsonable())
    assert again.cluster_events() == trace.cluster_events()
    evt = next(e for e in again.events if isinstance(e, wl.CorruptionEvent))
    return trace.to_jsonable(), evt.blocks


def test_gray_events_roundtrip_through_json():
    ref, port = both(_gray_json)
    assert port == ref
    assert port[1] == (("g0", 0, 1),)


def _gray_generated(s):
    cfg = s.sc.ScenarioConfig(
        duration=1.0, num_nodes=60, nodes_per_rack=3, max_concurrent_failures=3,
        crash_rate=8.0, mean_downtime=0.05, corruption_rate=6.0, slow_rate=6.0,
        mean_slow_time=0.1, seed=4,
    )
    trace = s.sc.generate_scenario(cfg)
    again = s.sc.trace_from_jsonable(trace.to_jsonable())
    assert again.cluster_events() == trace.cluster_events()
    return (trace.to_jsonable(), trace.max_concurrent_down(),
            any(isinstance(e, s.wl.CorruptionEvent) for e in trace.events),
            any(isinstance(e, s.wl.SlowNodeEvent) for e in trace.events))


def test_generated_gray_traces_are_deterministic_and_bounded():
    ref, port = both(_gray_generated)
    assert port == ref
    assert port[1] <= 3 and port[2] and port[3]


# ---------------------------------------------------------------------------
# gray traces: equal fingerprints, and never a wrong byte
# ---------------------------------------------------------------------------

def _gray_config(s, seed):
    return s.sc.ScenarioConfig(
        duration=0.5, num_nodes=60, nodes_per_rack=3, max_concurrent_failures=3,
        crash_rate=6.0, mean_downtime=0.08, transient_fraction=0.5,
        corruption_rate=8.0, corruption_blocks=2,
        slow_rate=6.0, slow_factor=0.2, mean_slow_time=0.1, seed=seed,
    )


def _gray_gateway(s):
    return _gateway(s, batch_window=0.01, cache_bytes=4 * 1024 * 1024, repair_on_failure=True,
                    repair_delay=0.03, record_payloads=True, scrub_interval=0.1,
                    decode_cost=0.002)


def _gray_run(s, seed, clean=False):
    trace = (s.sc.ScenarioTrace(num_nodes=60, nodes_per_rack=3) if clean
             else s.sc.generate_scenario(_gray_config(s, seed)))
    wl = s.wl.WorkloadConfig(num_objects=12, num_requests=100, arrival_rate=300.0, seed=seed)
    res = s.sc.run_scenario(_gray_gateway(s), trace, wl)
    return s.sc.deterministic_fingerprint(res), res


@pytest.mark.parametrize("seed", range(8))
def test_gray_trace_fingerprints_equal_the_reference(seed):
    (fp_ref, _), (fp_port, port) = both(_gray_run, seed)
    assert fp_port == fp_ref
    assert all(r.latency is not None for r in port.report.records)
    assert port.blocks_lost == 0 and port.durability["unreadable_objects"] == 0


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**16))
def test_gray_property_within_tolerance(seed):
    (fp_ref, ref), (fp_port, faulty) = both(_gray_run, seed)
    assert fp_port == fp_ref
    _fp, clean = _gray_run(SIDES["torch"], seed, clean=True)
    got = [(r.object_id, r.payload_digest) for r in faulty.report.records if r.kind == "get"]
    want = [(r.object_id, r.payload_digest) for r in clean.report.records if r.kind == "get"]
    assert got == want
    assert all(r.latency is not None for r in faulty.report.records)
    assert faulty.blocks_lost == 0 and faulty.durability["unreadable_objects"] == 0
    assert _gray_run(SIDES["torch"], seed)[0] == fp_port
