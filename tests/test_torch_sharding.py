"""The port's sharded front door (``ShardedGateway``) against the JAX
package's, and its own routing identity and failover (twins of
tests/test_sharding.py), under per-tile modeled billing so the simulated
clock never reads the wall clock. The port runs on the CPU
(``device="cpu"``, the kernels' plain torch versions); the JAX package
runs Pallas in interpret mode. Tolerance 0."""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core.product_code as jpc  # noqa: E402
import repro.gateway as jgw  # noqa: E402
import repro.storage.netmodel as jnet  # noqa: E402
import repro_torch.core.product_code as tpc  # noqa: E402
import repro_torch.gateway as tgw  # noqa: E402
import repro_torch.storage.netmodel as tnet  # noqa: E402

NUM_NODES = 60
SIDES = {
    "jax": (jpc, jgw, jnet, {"interpret": True}),
    "torch": (tpc, tgw, tnet, {"device": "cpu"}),
}


def _mk_sharded(side, num_shards, num_objects=24, q=2048, seed=5):
    """A small decode-bound sharded cluster + its request trace, as
    tests/test_sharding.py builds it (fewer objects and requests)."""
    pc, gw, net, kw = SIDES[side]
    tenants = [gw.TenantProfile("gold", arrival_rate=3000.0, weight=1.0, zipf_s=0.4)]
    cfg = gw.GatewayConfig(
        batch_window=0.005,
        decode_cost_per_tile=0.002,
        record_payloads=True,
        autotune=False,
        tenant_weights=gw.tenant_weight_map(tenants),
        tenant_slo_p99=gw.tenant_slo_map(tenants),
        **kw,
    )
    code = pc.CoreCode(9, 6, 3)
    g = gw.ShardedGateway(code, net.ClusterProfile.computation_critical(), NUM_NODES,
                          num_shards, cfg, vnodes=256)
    rng = np.random.default_rng(seed)
    g.load_objects(rng.integers(0, 256, (num_objects, code.k, q), dtype=np.uint8))
    reqs = gw.generate_tenant_requests(tenants, num_objects, 120, seed=seed)
    return g, reqs


def _failures(side, n):
    return SIDES[side][1].plan_failures(n, NUM_NODES, at_time=0.01, spacing=0.0, seed=5)


def _records(rep):
    return [(r.time, r.object_id, r.kind, r.degraded, r.latency, r.payload_digest)
            for r in rep.records]


def _digests(rep):
    return {(r.time, r.object_id): r.payload_digest for r in rep.completed if r.kind == "get"}


@pytest.fixture(scope="module")
def four_shards():
    out = {}
    for side in SIDES:
        g, reqs = _mk_sharded(side, 4)
        out[side] = (g, g.serve(reqs, _failures(side, 4)))
    return out


def test_four_shards_records_identical(four_shards):
    (gj, rj), (gt, rt) = four_shards["jax"], four_shards["torch"]
    assert len(rt.records) == 120
    assert _records(rt) == _records(rj)
    assert any(r.degraded for r in rt.records)
    for sid in gt.shards:
        assert _records(gt.last_reports[sid]) == _records(gj.last_reports[sid]), sid


def test_four_shards_routing_and_audit_identical(four_shards):
    (gj, _rj), (gt, _rt) = four_shards["jax"], four_shards["torch"]
    assert [gt.shard_of(oid) for oid in range(24)] == [gj.shard_of(oid) for oid in range(24)]
    assert len({gt.shard_of(oid) for oid in range(24)}) > 1
    assert gt.audit_durability() == gj.audit_durability()
    assert gt.audit_parity() == gj.audit_parity()
    for sid in gt.shards:
        sj, st = gj.shards[sid].coalescer.stats, gt.shards[sid].coalescer.stats
        assert (st.ops_by_kind, st.decode_calls, st.encode_calls) == (
            sj.ops_by_kind, sj.decode_calls, sj.encode_calls), sid


def test_sharded_serve_matches_unsharded_bytes(four_shards):
    """1 shard vs 4 shards in the port: byte-identical payloads per
    (time, object)."""
    g1, reqs = _mk_sharded("torch", 1)
    rep1 = g1.serve(reqs, _failures("torch", 4))
    _g4, rep4 = four_shards["torch"]
    assert len(rep1.completed) == len(reqs) == len(rep4.completed)
    d1, d4 = _digests(rep1), _digests(rep4)
    assert d1 and d1 == d4


def test_shard_death_failover_zero_loss():
    """Shard 1 dies mid-run: every request still completes, nothing is
    lost, only its objects re-route — and the JAX package's run of the
    same events gives the same records."""
    runs = {}
    for side in SIDES:
        g, reqs = _mk_sharded(side, 3)
        span = max(r.time for r in reqs)
        before = {oid: g.shard_of(oid) for oid in range(24)}
        death = SIDES[side][1].ShardFailEvent(time=span * 0.5, shard=1)
        runs[side] = (g, g.serve(reqs, _failures(side, 2) + [death]))
    g, rep = runs["torch"]
    assert g.dead_shards == {1} and g.live_shards() == [0, 2]
    assert len(rep.completed) == len(reqs)
    aud = g.audit_durability()
    assert aud["blocks_lost"] == 0 and aud["unreadable_objects"] == 0
    for oid, owner in before.items():
        if owner == 1:
            assert g.shard_of(oid) in {0, 2}
        else:
            assert g.shard_of(oid) == owner
    assert _records(rep) == _records(runs["jax"][1])


def test_sharded_gateway_rejects_zero_shards():
    with pytest.raises(ValueError):
        tgw.ShardedGateway(tpc.CoreCode(9, 6, 3), tnet.ClusterProfile.computation_critical(),
                           NUM_NODES, 0, tgw.GatewayConfig(device="cpu"))
