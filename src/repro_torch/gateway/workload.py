"""Workload synthesis for the serving gateway.

Object popularity is Zipfian (rank-r probability ∝ r^-s over a finite
catalog — the shape measured for blob/photo stores and the warehouse
traces the paper's related work studies), arrivals are Poisson, and node
failures are injected at configurable times. Everything is generated
host-side with numpy from a single seed so runs are reproducible.

Multi-tenant traces: each ``TenantProfile`` describes one tenant's
arrival rate, popularity skew, and fabric weight / latency SLO;
``generate_tenant_requests`` draws an independent Poisson/Zipf stream
per tenant over the shared catalog and merges them by arrival time, so
the gateway sees one interleaved trace of tenant-tagged requests.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

DEFAULT_TENANT = "foreground"


@dataclass(frozen=True)
class Request:
    time: float  # arrival (seconds since epoch 0 of the trace)
    object_id: int
    kind: str = "get"  # get | put | delete
    tenant: str = DEFAULT_TENANT  # fabric/SLO tenant this request bills to
    # PUT payload size in bytes. None => a full-row overwrite of the
    # object's k blocks (the pre-write-dataplane PUT). A value marks a
    # SMALL-object put: the gateway journals the payload and packs it
    # with other small objects into one codeword row (stripe sealing).
    nbytes: int | None = None


@dataclass(frozen=True)
class FailureEvent:
    """Node crash: the node goes dark but its disks survive — a matching
    ``NodeRecoverEvent`` brings the blocks back intact (reboot, network
    partition). The scenario engine (repro_torch.scenario) composes these with
    recoveries, capacity losses and load surges into full fault traces."""

    time: float
    node: int


@dataclass(frozen=True)
class NodeRecoverEvent:
    """Transient failure over: the node rejoins with its blocks intact.
    The gateway purges the node's negative cache entries on this event."""

    time: float
    node: int


@dataclass(frozen=True)
class CapacityLossEvent:
    """Permanent loss: the node's blocks are destroyed (disk failure);
    the node rejoins empty and only repair can restore the data."""

    time: float
    node: int


@dataclass(frozen=True)
class CorruptionEvent:
    """Silent corruption: blocks on ``node`` are damaged in place (bit
    flip or torn write) with their stored checksums left stale — the
    gateway notices nothing until a fetch or scrub verifies the bytes,
    then reclassifies the mismatch as an erasure (tombstone + degraded
    read + repair). ``blocks`` names explicit (group, row, col) victims;
    when empty, the first ``count`` blocks on the node (crc32-ordered,
    process-stable) are hit — ``count=0`` means every block on the node.
    """

    time: float
    node: int
    blocks: tuple = ()  # explicit BlockKey victims, () => derive from node
    mode: str = "bitflip"  # bitflip | torn | erase
    count: int = 1


@dataclass(frozen=True)
class SlowNodeEvent:
    """Fail-slow (gray) degradation: the node stays up and its bytes are
    intact, but every transfer it participates in runs at
    ``rate_factor`` x the healthy bandwidth. ``rate_factor=1.0``
    restores full speed (the recover edge of a flapping-slow pair)."""

    time: float
    node: int
    rate_factor: float = 0.1


@dataclass(frozen=True)
class SlowNicEvent:
    """Directional fail-slow: only the node's send or receive side
    degrades (a half-duplex NIC fault / oversubscribed uplink)."""

    time: float
    node: int
    rate_factor: float = 0.1
    direction: str = "send"  # send | recv


@dataclass(frozen=True)
class ShardFailEvent:
    """Whole-gateway-shard death: the serving process for one namespace
    shard dies mid-run. Storage is untouched (blocks live on the shared
    BlockStore fabric, not in the gateway), so ZERO blocks are lost —
    the sharded front door removes the dead shard's points from the
    consistent-hash directory and its namespace ranges fail over to the
    surviving shards. Consumed by ``ShardedGateway`` only; a standalone
    ``ObjectGateway`` has no shard to kill and rejects the event.
    ``node`` is fixed at -1 so the event can ride the same time-sorted
    cluster-event stream as node-level faults."""

    time: float
    shard: int
    node: int = -1


@dataclass(frozen=True)
class WorkloadConfig:
    num_objects: int
    num_requests: int
    arrival_rate: float = 200.0  # requests/sec (Poisson)
    zipf_s: float = 1.1  # popularity exponent
    put_fraction: float = 0.0  # fraction of requests that are PUTs
    seed: int = 0
    # write-churn shape: deletes tombstone the drawn object; a fraction
    # of PUTs may be SMALL (sealed into shared stripes) instead of
    # full-row overwrites. All three default off, so existing traces are
    # byte-identical (the extra rng draws happen after every preexisting
    # draw in the stream).
    delete_fraction: float = 0.0  # fraction of requests that are DELETEs
    small_put_fraction: float = 0.0  # fraction of PUTs that are small
    small_put_bytes: int = 256  # payload size of a small put


def zipf_probs(num_objects: int, s: float) -> np.ndarray:
    """Finite-catalog Zipf pmf: p(rank r) ∝ r^-s, r = 1..num_objects."""
    ranks = np.arange(1, num_objects + 1, dtype=np.float64)
    w = ranks**-s
    return w / w.sum()


def generate_requests(
    cfg: WorkloadConfig, tenant: str = DEFAULT_TENANT
) -> list[Request]:
    rng = np.random.default_rng(cfg.seed)
    gaps = rng.exponential(1.0 / cfg.arrival_rate, size=cfg.num_requests)
    times = np.cumsum(gaps)
    # Popular ranks are mapped to shuffled object ids so popularity is not
    # correlated with placement order.
    perm = rng.permutation(cfg.num_objects)
    ranks = rng.choice(cfg.num_objects, size=cfg.num_requests, p=zipf_probs(cfg.num_objects, cfg.zipf_s))
    kinds = np.where(rng.random(cfg.num_requests) < cfg.put_fraction, "put", "get")
    # churn draws LAST: a zero-fraction config consumes extra rng stream
    # only after every preexisting field is decided, so old traces stay
    # byte-identical
    deletes = rng.random(cfg.num_requests) < cfg.delete_fraction
    smalls = rng.random(cfg.num_requests) < cfg.small_put_fraction
    out = []
    for i in range(cfg.num_requests):
        kind = "delete" if deletes[i] else str(kinds[i])
        nbytes = (
            int(cfg.small_put_bytes)
            if (kind == "put" and smalls[i])
            else None
        )
        out.append(
            Request(
                time=float(times[i]),
                object_id=int(perm[ranks[i]]),
                kind=kind,
                tenant=tenant,
                nbytes=nbytes,
            )
        )
    return out


@dataclass(frozen=True)
class TenantProfile:
    """One tenant's traffic shape and service terms.

    ``weight`` is the fabric's weighted-fair quantum ratio (netmodel
    tenant_weights); ``slo_p99`` is the latency target (seconds) the
    gateway's admission controller enforces for this tenant (None =>
    best-effort, never rejected).
    """

    name: str
    arrival_rate: float  # requests/sec (Poisson)
    weight: float = 1.0
    zipf_s: float = 1.1
    put_fraction: float = 0.0
    slo_p99: float | None = None
    delete_fraction: float = 0.0
    small_put_fraction: float = 0.0
    small_put_bytes: int = 256

    def workload(self, num_objects: int, num_requests: int, seed: int) -> WorkloadConfig:
        return WorkloadConfig(
            num_objects=num_objects,
            num_requests=num_requests,
            arrival_rate=self.arrival_rate,
            zipf_s=self.zipf_s,
            put_fraction=self.put_fraction,
            seed=seed,
            delete_fraction=self.delete_fraction,
            small_put_fraction=self.small_put_fraction,
            small_put_bytes=self.small_put_bytes,
        )


def tenant_weight_map(profiles: list[TenantProfile]) -> dict[str, float]:
    return {p.name: p.weight for p in profiles}


def tenant_slo_map(profiles: list[TenantProfile]) -> dict[str, float]:
    return {p.name: p.slo_p99 for p in profiles if p.slo_p99 is not None}


def generate_tenant_requests(
    profiles: list[TenantProfile],
    num_objects: int,
    num_requests_per_tenant: int,
    seed: int = 0,
) -> list[Request]:
    """Independent Poisson/Zipf stream per tenant over the shared object
    catalog, merged by arrival time. Sub-seeds derive from the tenant
    NAME (not list position), so a tenant's stream stays stable when
    other tenants are added, dropped, or reordered."""
    merged: list[Request] = []
    for prof in profiles:
        sub_seed = (seed * 7919 + zlib.crc32(prof.name.encode())) % (2**31)
        wl = prof.workload(num_objects, num_requests_per_tenant, seed=sub_seed)
        merged.extend(generate_requests(wl, tenant=prof.name))
    merged.sort(key=lambda r: r.time)
    return merged


def plan_failures(
    num_failures: int,
    num_nodes: int,
    at_time: float = 0.0,
    spacing: float = 0.0,
    seed: int = 0,
) -> list[FailureEvent]:
    """Pick ``num_failures`` distinct victim nodes; fail the first at
    ``at_time`` and each subsequent one ``spacing`` seconds later."""
    rng = np.random.default_rng(seed + 7919)
    victims = rng.choice(num_nodes, size=num_failures, replace=False)
    return [
        FailureEvent(time=at_time + i * spacing, node=int(v))
        for i, v in enumerate(victims)
    ]
