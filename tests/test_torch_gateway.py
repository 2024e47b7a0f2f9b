"""The port's slice as a whole against the JAX package: ``ObjectGateway``
serving one degraded GET/PUT trace on both, with modeled billing so the
simulated clock never reads the wall clock.

The same numpy objects, trace and failed nodes go to the JAX gateway
(Pallas in interpret mode on the CPU) and to the port (``device="cpu"``,
the kernels' plain torch versions), both with ``autotune=False``: a
tuned tile width would change tile counts, and so billed latencies. Per-request
records, report counters, the parity audit, placement and stored bytes
must all be identical (tolerance 0), and ``BlockFixer.fix_group`` must
restore the same bytes on both.
"""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core.product_code as jpc  # noqa: E402
import repro.gateway as jgw  # noqa: E402
import repro.gateway.workload as jwl  # noqa: E402
import repro.storage.blockstore as jbs  # noqa: E402
import repro.storage.netmodel as jnet  # noqa: E402
import repro.storage.repair as jrep  # noqa: E402
import repro_torch.core.product_code as tpc  # noqa: E402
import repro_torch.gateway as tgw  # noqa: E402
import repro_torch.gateway.workload as twl  # noqa: E402
import repro_torch.storage.blockstore as tbs  # noqa: E402
import repro_torch.storage.netmodel as tnet  # noqa: E402
import repro_torch.storage.repair as trep  # noqa: E402

# side -> (product_code, gateway, workload, netmodel, repair, blockstore,
# gateway config keywords, codec/fixer keywords)
SIDES = {
    "jax": (jpc, jgw, jwl, jnet, jrep, jbs, {"autotune": False, "interpret": True}, {}),
    "torch": (tpc, tgw, twl, tnet, trep, tbs, {"autotune": False, "device": "cpu"},
              {"device": "cpu"}),
}
# the failed blocks: column 0 of g0 needs "H" decodes, g1 row 0 "V" repairs
VICTIMS = (("g0", 0, 0), ("g0", 1, 0), ("g1", 0, 2))


def _gateway(side):
    pc, gw, _wl, net, _rep, _bs, kw, _dev = SIDES[side]
    cfg = gw.GatewayConfig(
        batch_window=0.01, record_payloads=True,
        decode_cost_per_tile=1e-5, encode_cost=2e-4, **kw,
    )
    g = gw.ObjectGateway(pc.CoreCode(9, 6, 3), net.ClusterProfile.network_critical(), 60, cfg)
    rng = np.random.default_rng(9)
    g.load_objects(rng.integers(0, 256, (12, 6, 2048), dtype=np.uint8))
    return g


def _serve(side):
    _pc, gw, wl, _net, _rep, _bs, _kw, _dev = SIDES[side]
    g = _gateway(side)
    reqs = gw.generate_requests(
        gw.WorkloadConfig(num_objects=12, num_requests=150, arrival_rate=3000.0,
                          put_fraction=0.15, seed=4)
    )
    failures = [
        wl.FailureEvent(time=0.005 + 0.01 * i, node=g.store.node_of(key))
        for i, key in enumerate(VICTIMS)
    ]
    return g, g.serve(reqs, failures)


@pytest.fixture(scope="module")
def served():
    return {side: _serve(side) for side in SIDES}


def test_records_identical(served):
    (_gj, rj), (_gt, rt) = served["jax"], served["torch"]
    fields = ("time", "object_id", "kind", "degraded", "payload_digest", "latency")
    ours = [tuple(getattr(r, f) for f in fields) for r in rt.records]
    theirs = [tuple(getattr(r, f) for f in fields) for r in rj.records]
    assert len(ours) == 150
    assert ours == theirs
    kinds = [r.kind for r in rt.records]
    assert kinds.count("put") > 0 and any(r.degraded for r in rt.records)
    gets = [r for r in rt.records if r.kind == "get"]
    assert rt.metrics.counter_total("verified_gets") == len(gets)


def test_report_counters_identical(served):
    (gj, rj), (gt, rt) = served["jax"], served["torch"]
    for name in ("decode_launches", "jit_cache_entries", "padded_byte_ratio",
                 "launches_per_window"):
        assert getattr(rt, name) == getattr(rj, name), name
    sj, st = gj.coalescer.stats, gt.coalescer.stats
    for name in ("ops_by_kind", "sources_by_kind", "encode_calls", "encode_ops",
                 "decode_calls", "decode_ops", "staged_bytes", "padded_bytes",
                 "batch_hist", "jit_retraces"):
        assert getattr(st, name) == getattr(sj, name), name
    assert all(st.ops_by_kind.get(k, 0) > 0 for k in ("H", "V", "EH", "EV")), st.ops_by_kind


def test_parity_audit_identical(served):
    (gj, _rj), (gt, _rt) = served["jax"], served["torch"]
    audit = gt.audit_parity()
    assert audit == gj.audit_parity()
    assert audit["stale_blocks"] == 0 and audit["corrupt_blocks"] == 0


def test_stored_bytes_identical_after_serve(served):
    (gj, _rj), (gt, _rt) = served["jax"], served["torch"]
    assert gt.store.placement == gj.store.placement
    assert sorted(gt.store.blocks) == sorted(gj.store.blocks)
    for key, block in gj.store.blocks.items():
        np.testing.assert_array_equal(gt.store.blocks[key], block)


def test_load_objects_places_and_stores_identically():
    """Data plays the part of weights: the same numpy objects rebuild the
    same store, block for block and node for node (crc32 placement)."""
    gj, gt = _gateway("jax"), _gateway("torch")
    assert gt.store.placement == gj.store.placement
    assert gt.store.checksums == gj.store.checksums
    assert sorted(gt.store.blocks) == sorted(gj.store.blocks)
    for key, block in gj.store.blocks.items():
        np.testing.assert_array_equal(gt.store.blocks[key], block)


@pytest.mark.parametrize(
    "mode,cells",
    [
        ("core", ((1, 3),)),  # one vertical repair
        ("core", ((1, 0), (1, 1), (1, 2), (1, 3))),  # beyond RS: m + 1 in a row
        ("hdfs_raid_opt", ((2, 1), (2, 7))),  # one horizontal decode
    ],
)
def test_fix_group_restores_identical_blocks(mode, cells):
    reports, stores = {}, {}
    for side, (pc, _gw, _wl, net, rep, bs, _kw, codec_kw) in SIDES.items():
        code = pc.CoreCode(9, 6, 3)
        store = bs.BlockStore(num_nodes=60)
        objects = np.random.default_rng(5).integers(0, 256, (3, 6, 1024), dtype=np.uint8)
        matrix = _host(pc.CoreCodec(code, **codec_kw).encode(objects))
        store.put_group("g0", matrix)
        store.fail_nodes([store.node_of(("g0", r, c)) for r, c in cells])
        fixer = rep.BlockFixer(store, code, net.ClusterProfile.network_critical(),
                               mode=mode, **codec_kw)
        reports[side] = fixer.fix_group("g0")
        stores[side] = (store, matrix)
    rj, rt = reports["jax"], reports["torch"]
    for name in ("mode", "blocks_fetched", "bytes_fetched", "blocks_repaired",
                 "network_time", "schedule", "recovered"):
        assert getattr(rt, name) == getattr(rj, name), name
    assert rt.recovered
    (st, mt), (sj, _mj) = stores["torch"], stores["jax"]
    for r, c in cells:
        np.testing.assert_array_equal(st.blocks[("g0", r, c)], mt[r, c])
        np.testing.assert_array_equal(st.blocks[("g0", r, c)], sj.blocks[("g0", r, c)])


def _host(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
