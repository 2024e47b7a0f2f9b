"""The object-storage serving gateway: request-driven PUT/GET over the
simulated CORE cluster, end to end.

Requests (Poisson arrivals) are grouped into small batching windows; each
window's GETs are planned against the live failure set (planner.py) and
their reconstructions coalesced into batched kernel launches
(coalescer.py). Every byte moved rides the shared NetSimulator fabric —
where background repair traffic (BlockFixer as the "repair" tenant)
contends with foreground reads, instead of running in a separate
universe. Block contents are real; every degraded GET is verified
against ground truth.

Multi-tenant QoS: every request carries a tenant tag, and each tenant's
fabric transfers ride the quantum scheduler under that tenant's
weighted-fair ratio (``GatewayConfig.tenant_weights`` — repair is just
another tenant whose weight defaults to ``background_share``). Tenants
may declare a p99 latency SLO (``tenant_slo_p99``); the admission
controller estimates an arriving GET's completion time (client-NIC fetch
serialization + decode-engine backlog + measured per-launch decode cost)
and, when the estimate busts the tenant's SLO, either rejects the
request up front (``admission="reject"``) or first degrades it to the
latency-cheapest viable plan (``admission="degrade"``, re-ranking the
planner's candidates by estimated time instead of Table-1 bytes) and
rejects only if even that plan busts the target. Rejections are tracked
per tenant in ``GatewayReport.rejections``.

Pipeline stages (config.pipeline):

  1. **fetch**   — every source block of the window's plans is scheduled
     on the fabric at the request's plan time (``ReadPlan.planned_at``);
     cache hits are ready immediately. Under the quantum fabric
     (config.fabric) these transfers preempt long background repair
     transfers at quantum granularity instead of queueing behind them.
  2. **decode**  — reconstructions are deduped across the window and
     executed by the ragged megakernel dataplane
     (``config.coalesce="ragged"``, the default): the whole window's
     mixed-shape decode set is staged as fixed-width descriptor tiles
     and decoded in chunked CUDA tile-kernel launches per kind (two
     chunk rungs bound the launch signatures at <= 2 per kind; see
     gateway/coalescer.py).
     The coalescer returns LaunchUnits — a megakernel launch is split
     by tile ranges into one unit per op — and each unit is dispatched
     least-loaded-first onto ``num_engines`` parallel simulated
     decode-engine timelines once its LAUNCH's source transfers have
     all completed (a physical launch's staging buffer holds every one
     of its ops' tiles) and an engine frees, so a single physical
     launch still spreads across the pool. ``coalesce="bucketed"`` keeps the
     shape-bucketed dataplane (one stacked launch per (kind, M, K,
     blocklen) bucket, ladder-padded) as the measured baseline.
  3. **verify / deliver** — each GET completes at the max of its direct
     fetches and the decode launches it depends on; contents are checked
     against ground truth host-side (zero simulated cost).

In ``pipelined`` mode (default) the stages overlap across windows:
window N+1's fabric transfers proceed while window N's decode launches
occupy the engine, and the engine drains buckets in source-arrival
order. ``serial`` mode is the comparison baseline: it charges the
serialization a synchronous flush-per-batch loop actually implies — a
window's transfers may not start before the previous window fully
completed, no launch is issued before ALL the window's transfers land,
the launches run back-to-back, and every degraded GET of the window
waits for the last of them. (The PR-1 loop executed stages strictly in
sequence but its simulated timestamps let them overlap optimistically;
serial mode prices that loop honestly rather than reproducing its
accounting.)

Fabric quantum model (storage/netmodel.py): transfers are scheduled in
fixed full-rate quanta; a priority class with share s may claim one
quantum per quantum/s of wall time per port, so the holes a throttled
background class leaves are real preemption points for foreground reads
— ``background_share`` is a weighted-fair quantum ratio, not a rate cap.

Latency model per request: arrival -> (cache | fabric transfers to the
request's client port) -> per-bucket decode on the shared engine ->
completion. Decode compute is measured on the real kernels (autotuned
per device, launch signatures bounded — two chunk rungs per kind on the
ragged path, a fixed batch ladder on the bucketed one —
GatewayReport.jit_cache_entries) and scaled by the cluster profile.

Fault scenarios (repro_torch.scenario): ``serve`` consumes node-level cluster
events mid-run — transient crashes (FailureEvent), recoveries
(NodeRecoverEvent: blocks return intact, negative cache entries purged)
and capacity losses (CapacityLossEvent: blocks destroyed, only repair
restores them). Blocks on down nodes are negative-cached with a TTL so
planning skips re-probing known failures; loss times feed MTTR samples
when repair heals (``GatewayReport.mttr_samples``) or the node recovers
(``restored_samples``), and ``audit_durability`` reports provable data
loss for traces beyond the code's tolerance.

Closed-loop repair pacing (``repair_pacing=True``): before each group
repair, a PacingController (storage/repair.py) maps the protected
tier's recent p99 headroom against ``tenant_slo_p99`` — plus an MTTR
urgency term as the repair drags — to the "repair" tenant's fabric
weight AND decode-engine share, applied via
``NetSimulator.set_tenant_weight`` and ``EnginePool.set_weight``:
repair backs off while foreground latency is at risk and accelerates
toward the MTTR target when idle. Decisions land in
``GatewayReport.pacing``. Repair decode compute itself is billed on the
shared engine pool as the "repair" tenant, so engine shares bite both
ways.
"""

from __future__ import annotations

import hashlib
import zlib
from collections import deque
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.coding import rs
from repro_torch.coding.gf256 import np_matmul
from repro_torch.core.failure_matrix import independent_clusters
from repro_torch.core.product_code import CoreCode, CoreCodec
from repro_torch.core.recoverability import is_recoverable
from repro_torch.gateway.cache import LRUBlockCache
from repro_torch.gateway.coalescer import DecodeCoalescer
from repro_torch.gateway.metadata import MetadataPlane
from repro_torch.gateway.planner import (
    DecodeOp,
    DegradedReadPlanner,
    ReadPlan,
    UnreadableObjectError,
    make_family,
)
from repro_torch.gateway.sealer import Extent, StripeSealer
from repro_torch.gateway.workload import (
    CapacityLossEvent,
    CorruptionEvent,
    DEFAULT_TENANT,
    FailureEvent,
    NodeRecoverEvent,
    Request,
    SlowNicEvent,
    SlowNodeEvent,
)
from repro_torch.kernels import autotune
from repro_torch.obs import host
from repro_torch.obs.metrics import BoundedLog, BoundedSamples, MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.storage.blockstore import BlockKey, BlockStore
from repro_torch.storage.netmodel import (
    ClusterProfile,
    FOREGROUND_TENANT,
    NetSimulator,
    REPAIR_TENANT,
    PortTimeline,
    Transfer,
    shard_tenant,
)
from repro_torch.storage.repair import BlockFixer, PacingController, Scrubber

PIPELINED = "pipelined"
SERIAL = "serial"

# Sealed-stripe rows register as synthetic objects above this id, so
# they can never collide with workload-drawn tenant object ids.
SEAL_OID_BASE = 1 << 40

# Admission-control policies (GatewayConfig.admission):
#   off     — admit everything (SLOs are observed, never enforced)
#   reject  — refuse a GET whose estimated completion busts its SLO
#   degrade — first re-rank the planner's candidate plans by estimated
#             completion time and take the cheapest; reject only if even
#             that plan busts the SLO
ADMIT_OFF = "off"
ADMIT_REJECT = "reject"
ADMIT_DEGRADE = "degrade"


@dataclass(frozen=True)
class GatewayConfig:
    batch_window: float = 0.002  # seconds of arrival coalescing
    cache_bytes: int = 0  # 0 disables the block cache
    cache_policy: str = "cost"  # "cost" (rebuild-cost-aware) | "lru"
    num_client_ports: int = 32  # parallel client-side NICs
    background_share: float = 0.5  # repair's weighted-fair quantum ratio
    fabric: str = "quantum"  # "quantum" (preemptive) | "fifo"
    repair_on_failure: bool = False  # run BlockFixer after detection
    repair_delay: float = 5.0  # failure-detection lag (seconds)
    verify: bool = True  # check every GET against ground truth
    # where the codec and tile kernels run: "cuda" (the card; raises
    # without CUDA) or "cpu" (the plain torch path, for tests)
    device: str | None = "cuda"
    pipeline: str = PIPELINED  # "pipelined" | "serial" (PR-1 loop)
    autotune: bool = True  # measured kernel-parameter sweep at first use
    # decode dataplane: "ragged" = chunked tile-kernel launches per
    # (window, kind); "bucketed" = the per-shape stacked launches (kept
    # as the measured baseline)
    coalesce: str = "ragged"
    record_payloads: bool = False  # sha256 of every GET payload in records
    # -- multi-tenant QoS ------------------------------------------------------
    tenant_weights: dict | None = None  # tenant -> fabric quantum ratio
    tenant_slo_p99: dict | None = None  # tenant -> p99 latency target (s)
    admission: str = ADMIT_OFF  # "off" | "reject" | "degrade"
    num_engines: int = 1  # parallel simulated decode engines
    # tenant -> decode-engine share in (0, 1]. Independent of the fabric
    # weights: a throttled tenant's launches are rate-capped at
    # share x pool throughput; unlisted tenants dispatch at full weight
    # (identical to the tenant-blind least-loaded behavior).
    engine_weights: dict | None = None
    # Modeled decode cost: when set, every decode launch (and each
    # repaired block's codec work) is billed this many scaled seconds
    # instead of the measured kernel wall time. Payload bytes still come
    # off the real kernels — only the TIMING model changes — so a run
    # becomes bit-for-bit replayable (golden traces, paced-vs-fixed
    # comparisons) with no cold-vs-warm-jit sensitivity. None (default):
    # measured, best-observed-per-signature billing.
    decode_cost: float | None = None
    # Modeled decode cost PER DESCRIPTOR TILE: bills each megakernel
    # launch unit ``cost x its tile count``, so billed compute scales
    # with the work actually launched instead of the launch count.
    # decode_cost (per launch) models a fixed-cost accelerator
    # dispatch; per-tile models a throughput-bound accelerator — the
    # right replayable model when comparing configurations that split
    # the SAME op stream into DIFFERENT window sizes (the sharded
    # scale-out bench: N shards cut windows ~N ways, and per-launch
    # billing would charge the cluster N times for the same tiles).
    # Requires coalesce="ragged" (bucketed units carry no tile counts)
    # and is mutually exclusive with decode_cost.
    decode_cost_per_tile: float | None = None
    # -- write dataplane -------------------------------------------------------
    # Modeled ENCODE cost per launch (same semantics as decode_cost);
    # None falls back to decode_cost, and to the coalescer's measured
    # encode history when both are None. Encode launches are billed on
    # the SAME engine pool decodes ride, so PUT latency reflects the
    # engine backlog and writes push back on degraded reads.
    encode_cost: float | None = None
    # write dataplane shape: "ragged" = one descriptor-driven encode
    # megakernel window per PUT batch (EH parity-row generation + EV
    # XOR-delta parity folds, one launch per kind); "sync" = one
    # launch pair PER PUT (the synchronous write baseline the bench
    # compares against).
    write_coalesce: str = "ragged"
    # -- fault scenarios / closed-loop repair ---------------------------------
    negative_ttl: float = 5.0  # seconds a known-down block stays negative-cached
    repair_pacing: bool = False  # SLO-aware closed-loop repair pacing
    repair_min_share: float = 0.5  # pacer floor (fabric + engine share)
    repair_max_share: float = 1.0  # pacer ceiling (idle / healthy)
    repair_mttr_target: float | None = None  # urgency override threshold (s)
    pacing_window: float = 1.0  # seconds of latency history the pacer observes
    # Incremental repair drain: at most this many groups repair per
    # boundary event, with the remainder requeued repair_respacing
    # seconds later (None => the whole backlog in one shot, the
    # pre-scenario behavior). Spreading the drain is what lets the
    # pacer RE-OBSERVE foreground latency between batches — the loop
    # cannot close inside one atomic repair event.
    repair_groups_per_run: int | None = None
    repair_respacing: float = 0.05
    # -- integrity / gray-failure hardening -----------------------------------
    # Verify every store fetch's crc32 digest (and every decode output
    # against its target's reference digest). A mismatch is reclassified
    # as an ERASURE: quarantine + negative-cache tombstone + replan as a
    # degraded read + repair queue. Zero simulated cost (checksumming is
    # local disk-speed work on each node), so enabling it on a clean
    # cluster changes no timings.
    verify_checksums: bool = True
    # Hedged fetches: when a direct data-block fetch is going to land
    # later than hedge_threshold x its healthy-fabric estimate (fair-
    # share serialization + the tenant's own committed backlog), launch
    # the cheapest single-block recovery plan (CORE vertical XOR first,
    # RS row fallback) speculatively and take the first verified winner.
    hedge: bool = False
    hedge_threshold: float = 2.0
    hedge_max_retries: int = 2  # speculative attempts per request
    hedge_backoff: float = 2.0  # deadline multiplier per extra attempt
    # Per-tenant hedge-byte budget: cumulative speculative fabric bytes
    # may not exceed this fraction of the tenant's primary fetch bytes —
    # the structural cap that keeps hedging from stampeding the fabric.
    hedge_budget: float = 0.05
    # Background scrubber: every scrub_interval simulated seconds, verify
    # up to scrub_blocks_per_run stored blocks (paced down by the repair
    # PacingController when foreground SLOs are at risk) so latent
    # corruption is found before reads trip over it. None disables.
    scrub_interval: float | None = None
    scrub_blocks_per_run: int = 64
    # -- observability (repro_torch.obs) --------------------------------------------
    tracing: bool = False  # emit sim-time spans into a bounded Tracer
    # sampling policy: "always" | "head:N" | "tail:SECONDS" | comma-combos
    # (keep a trace if ANY matches — slow requests are never dropped)
    trace_sample: str = "always"
    trace_capacity: int = 65536  # span ring-buffer size
    # False => streaming mode: GatewayReport keeps NO per-request list
    # (records stays empty; aggregates come from the bounded metrics
    # registry) so resident memory is O(1) in trace length
    record_requests: bool = True
    # -- code family (per-namespace property) ----------------------------------
    # "core" (the (n,k,t) product code, default), "rs" (plain (n,k)
    # Reed-Solomon rows — the paper's traditional-EC baseline), or "lrc"
    # ((n,k) Azure-style Local Reconstruction Code rows). RS/LRC derive
    # (n,k) from the gateway's CoreCode so all families stripe the same
    # row geometry; planner candidates, repair plans, PUT re-encode, and
    # the durability audit all go through repro_torch.gateway.planner.CodeFamily.
    code_family: str = "core"
    # -- placement / scale-out -------------------------------------------------
    # Rack size for failure-domain-aware placement: nodes [i*r, (i+1)*r)
    # form rack i, and stripe placement guarantees any single rack
    # failure costs each row and each column at most one block (XORing
    # Elephants, 1301.3791). None keeps node-level anti-colocation only.
    nodes_per_rack: int | None = None


@dataclass
class RequestRecord:
    time: float
    object_id: int
    kind: str
    latency: float | None  # None => unrecoverable or rejected
    degraded: bool
    bytes_read: int  # fabric bytes moved for this request
    reconstruction_blocks: int  # planner's Table-1 traffic
    cache_hits: int
    payload_digest: str | None = None  # sha256 (record_payloads=True)
    tenant: str = DEFAULT_TENANT
    rejected: bool = False  # refused by SLO admission control


# Completed GETs the repair pacer can observe: (arrival, tenant,
# latency), last RECENT_CAP only — the trailing pacing_window never
# needs more, and the cap is what keeps the pacer's input bounded.
RECENT_CAP = 4096


@dataclass
class GatewayReport:
    """Per-``serve()`` outcome report: a snapshot over the streaming
    ``metrics`` registry plus (by default) the raw per-request records.

    Every sample container here is BOUNDED: ``mttr_samples`` /
    ``restored_samples`` keep exact streaming count/mean/max plus a
    capped prefix of raw samples, ``pacing`` keeps the last decisions,
    ``recent`` the trailing completed GETs the repair pacer reads, and
    the registry's histograms are fixed-bin sketches — so with
    ``GatewayConfig.record_requests=False`` (streaming mode, ``records``
    stays empty) resident memory is O(1) in trace length. The aggregate
    accessors fall back from exact record scans to the registry in that
    mode; only WINDOWED percentiles (``since``/``until``) require
    records."""

    records: list[RequestRecord] = field(default_factory=list)
    repair_reports: list = field(default_factory=list)
    jit_cache_entries: int = 0  # coalescer's traced-signature count
    decode_launches: int = 0  # physical kernel launches (cumulative)
    launches_per_window: float = 0.0  # decode launches per batching window
    padded_byte_ratio: float = 0.0  # filler fraction of staged decode bytes
    rejections: dict = field(default_factory=dict)  # tenant -> refused GETs
    put_rejections: dict = field(default_factory=dict)  # tenant -> refused PUTs
    # time from block loss to repair-heal completion, one sample per
    # block healed by BlockFixer during this serve() call
    mttr_samples: BoundedSamples = field(default_factory=BoundedSamples)
    # time from block loss to availability restoration via a
    # NodeRecoverEvent (transient failure over — no repair bytes moved)
    restored_samples: BoundedSamples = field(default_factory=BoundedSamples)
    # time from silent-corruption injection to checksum detection (fetch
    # verify or scrub), one sample per corrupt block detected
    corruption_latency: BoundedSamples = field(default_factory=BoundedSamples)
    # closed-loop repair pacing decisions: (simulated time, share)
    pacing: BoundedLog = field(default_factory=BoundedLog)
    # streaming metrics registry: labeled counters / gauges / histograms
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)
    recent: deque = field(default_factory=lambda: deque(maxlen=RECENT_CAP))
    record_requests: bool = True  # False => streaming mode (records empty)
    _first_arrival: float = float("inf")
    _last_completion: float = 0.0

    def add_record(self, rec: RequestRecord) -> None:
        """Route one finished request into the report: the raw record
        list (unless streaming mode), the metrics registry, and the
        pacer's bounded ``recent`` window."""
        if self.record_requests:
            self.records.append(rec)
        m = self.metrics
        m.counter("requests", kind=rec.kind, tenant=rec.tenant).inc()
        if rec.rejected:
            m.counter("rejected_requests", tenant=rec.tenant).inc()
        if rec.latency is None:
            return
        m.counter("completed", kind=rec.kind, tenant=rec.tenant).inc()
        m.histogram("latency", kind=rec.kind, tenant=rec.tenant).observe(
            max(rec.latency, 1e-9)
        )
        m.counter("bytes_read", tenant=rec.tenant).inc(rec.bytes_read)
        self._first_arrival = min(self._first_arrival, rec.time)
        self._last_completion = max(self._last_completion, rec.time + rec.latency)
        if rec.kind == "get":
            self.recent.append((rec.time, rec.tenant, rec.latency))
            if rec.degraded:
                m.counter("degraded_gets").inc()
                m.counter("degraded_bytes").inc(rec.bytes_read)
                m.counter("degraded_recon_blocks").inc(rec.reconstruction_blocks)

    def resident_samples(self) -> int:
        """Total retained entries across every sample container — the
        number the long-trace benchmark gates on staying bounded."""
        return (
            len(self.records)
            + len(self.recent)
            + self.mttr_samples.resident()
            + self.restored_samples.resident()
            + self.corruption_latency.resident()
            + self.pacing.resident()
            + self.metrics.resident_samples()
        )

    @property
    def mttr_mean(self) -> float:
        return self.mttr_samples.mean

    @property
    def mttr_max(self) -> float:
        return self.mttr_samples.max

    # -- aggregates -----------------------------------------------------------
    @property
    def completed(self) -> list[RequestRecord]:
        return [r for r in self.records if r.latency is not None]

    @property
    def degraded_gets(self) -> list[RequestRecord]:
        return [r for r in self.completed if r.kind == "get" and r.degraded]

    @property
    def rejected(self) -> list[RequestRecord]:
        return [r for r in self.records if r.rejected]

    def latency_percentile(
        self, q: float, since: float = 0.0, until: float = float("inf")
    ) -> float:
        """Latency percentile over requests ARRIVING in [since, until) —
        the one quantile definition every window statistic delegates to.
        Streaming mode answers WHOLE-trace quantiles from the registry's
        merged latency sketch; windowed quantiles need records."""
        if not self.records and since == 0.0 and until == float("inf"):
            h = self.metrics.merged_histogram("latency")
            return h.quantile(q / 100.0) if h is not None else 0.0
        lats = [r.latency for r in self.completed if since <= r.time < until]
        return float(np.percentile(lats, q)) if lats else 0.0

    # -- per-tenant aggregates -------------------------------------------------
    def tenant_completed(self, tenant: str) -> list[RequestRecord]:
        return [r for r in self.completed if r.tenant == tenant]

    def tenant_latency_percentile(
        self,
        tenant: str,
        q: float,
        since: float = 0.0,
        until: float = float("inf"),
    ) -> float:
        if not self.records and since == 0.0 and until == float("inf"):
            h = self.metrics.merged_histogram("latency", tenant=tenant)
            return h.quantile(q / 100.0) if h is not None else 0.0
        lats = [
            r.latency
            for r in self.completed
            if r.tenant == tenant and since <= r.time < until
        ]
        return float(np.percentile(lats, q)) if lats else 0.0

    def slo_violation_rate(self, tenant: str, slo: float) -> float:
        """Fraction of this tenant's completed GETs that finished over
        the target — measured over ADMITTED traffic, so rejections trade
        availability for the survivors' latency."""
        gets = [r for r in self.tenant_completed(tenant) if r.kind == "get"]
        if not gets and not self.records:
            h = self.metrics.merged_histogram("latency", kind="get", tenant=tenant)
            return 1.0 - h.cdf(slo) if h is not None and h.count else 0.0
        if not gets:
            return 0.0
        return sum(1 for r in gets if r.latency > slo) / len(gets)

    @property
    def throughput(self) -> float:
        """Completed requests per second of simulated trace time."""
        n = self.metrics.counter_total("completed")
        if not n:
            return 0.0
        span = self._last_completion - self._first_arrival
        return n / span if span > 0 else float("inf")

    @property
    def bytes_per_degraded_get(self) -> float:
        deg = self.metrics.counter_total("degraded_gets")
        return (
            self.metrics.counter_total("degraded_bytes") / deg if deg else 0.0
        )

    @property
    def reconstruction_blocks_per_degraded_get(self) -> float:
        deg = self.metrics.counter_total("degraded_gets")
        return (
            self.metrics.counter_total("degraded_recon_blocks") / deg
            if deg
            else 0.0
        )

    # -- cross-shard aggregation ------------------------------------------------
    @classmethod
    def merged(cls, reports: list["GatewayReport"]) -> "GatewayReport":
        """One logical report over N shard reports: records are replayed
        through ``add_record`` in (time, object, kind) order so every
        derived aggregate — metrics counters, latency sketches, the
        throughput window, the pacer's ``recent`` deque — is rebuilt
        exactly as a single gateway would have built it; sample
        containers and rejection maps are summed. Existing bench blocks
        read the merged report through the same pinned keys."""
        for r in reports:
            if not r.record_requests:
                raise ValueError(
                    "GatewayReport.merged needs per-request records; "
                    "run shards with record_requests=True"
                )
        out = cls(record_requests=True)
        for rec in sorted(
            (rec for r in reports for rec in r.records),
            key=lambda rec: (rec.time, rec.object_id, rec.kind),
        ):
            out.add_record(rec)
        for r in reports:
            out.repair_reports.extend(r.repair_reports)
            # jit entries: shards run private coalescers over identical
            # kernels — the MAX is the per-process signature footprint
            out.jit_cache_entries = max(out.jit_cache_entries, r.jit_cache_entries)
            out.decode_launches += r.decode_launches
            for t, n in r.rejections.items():
                out.rejections[t] = out.rejections.get(t, 0) + n
            for t, n in r.put_rejections.items():
                out.put_rejections[t] = out.put_rejections.get(t, 0) + n
            for s in r.mttr_samples:
                out.mttr_samples.append(s)
            for s in r.restored_samples:
                out.restored_samples.append(s)
            for s in r.corruption_latency:
                out.corruption_latency.append(s)
            for p in r.pacing:
                out.pacing.append(p)
        n_windows = sum(
            r.decode_launches / r.launches_per_window
            for r in reports
            if r.launches_per_window > 0
        )
        if n_windows > 0:
            out.launches_per_window = out.decode_launches / n_windows
        return out


class EnginePool:
    """``num_engines`` parallel simulated decode-engine timelines with
    least-loaded dispatch and per-tenant weighted admission.

    Full-weight tenants dispatch exactly as the tenant-blind pool did:
    earliest-free engine, start at max(ready, engine_free). A tenant with
    share w < 1 additionally respects a virtual-clock cursor spaced at
    duration / (w x pool_size) per launch, rate-capping it at w of the
    pool's aggregate throughput — so a throttled repair tenant's decode
    work cannot crowd foreground reconstructions off the engines, and
    the SLO pacer can modulate that share mid-run (``set_weight``).

    Engines keep interval timelines (the fabric's PortTimeline), not
    just a high-water mark: the idle gap a throttled tenant's cursor
    wait leaves on an engine is a real hole later full-weight launches
    backfill — throttling yields capacity to other tenants instead of
    reserving dead time (mirroring the quantum fabric's preemptible
    holes). On hole-free timelines earliest-fit placement coincides
    with least-loaded dispatch, so all-full-weight workloads are
    schedule-identical to the tenant-blind pool."""

    def __init__(self, num_engines: int, weights: dict | None = None):
        self.free = [0.0] * num_engines  # per-engine last-end high-water mark
        self._timelines = [PortTimeline() for _ in range(num_engines)]
        self._weights: dict = dict(weights or {})
        for tenant, w in self._weights.items():
            self._check_weight(tenant, w)
        self._cursor: dict = {}
        self.tracer = NULL_TRACER  # engine-track span sink (repro_torch.obs)
        self._tracks = [("engine", f"engine{e}") for e in range(num_engines)]

    @staticmethod
    def _check_weight(tenant, w) -> None:
        if not 0.0 < w <= 1.0:
            raise ValueError(
                f"engine weight must be in (0, 1], got {tenant!r}: {w}"
            )

    def weight_of(self, tenant) -> float:
        return self._weights.get(tenant, 1.0)

    def set_weight(self, tenant, w: float) -> None:
        self._check_weight(tenant, w)
        self._weights[tenant] = w

    def earliest_start(self, now: float) -> float:
        """Earliest instant at/after ``now`` any engine could begin new
        work, holes included — the admission estimator's view of decode
        queueing. (The per-engine high-water marks in ``free`` are NOT
        usable for this: a throttled tenant's cursor-delayed booking
        pushes them far out while the timeline before it stays idle.)
        Probes for a 1 us hole — anything above the timeline's float
        tolerance, below which zero-length gaps are accepted."""
        return min(tl.next_fit(now, 1e-6) for tl in self._timelines)

    def dispatch(
        self, ready: float, dur: float, tenant=None, ctx: tuple | None = None
    ) -> tuple[float, float]:
        """Schedule one launch; returns (start, end). ``ctx`` is an
        optional (trace_id, parent_id, attrs) observability context —
        when given (and tracing is on) the launch emits an engine-track
        span into that trace. Purely observational: the schedule is
        identical with or without it."""
        share = 1.0 if tenant is None else self.weight_of(tenant)
        if share < 1.0:
            ready = max(ready, self._cursor.get(tenant, 0.0))
        # earliest-fit across engines (holes included); ties break on the
        # lowest index, which on hole-free timelines is least-loaded
        best_e, best_start = 0, float("inf")
        for e, tl in enumerate(self._timelines):
            s = tl.next_fit(ready, dur) if dur > 0.0 else max(ready, self.free[e])
            if s < best_start:
                best_e, best_start = e, s
        end = best_start + dur
        if dur > 0.0:
            self._timelines[best_e].occupy(best_start, end)
        self.free[best_e] = max(self.free[best_e], end)
        if share < 1.0 and dur > 0.0:
            spacing = dur / (share * len(self.free))
            self._cursor[tenant] = max(
                self._cursor.get(tenant, 0.0) + spacing, best_start + spacing
            )
        if ctx is not None and self.tracer.enabled and dur > 0.0:
            tid, pid, attrs = ctx
            self.tracer.span(
                "engine.launch",
                best_start,
                end,
                tid,
                pid,
                track=self._tracks[best_e],
                tenant=tenant,
                **attrs,
            )
        return best_start, end


class ObjectGateway:
    """Serves a trace of PUT/GET requests over a BlockStore cluster.

    Standalone by default: constructs its own store, fabric and
    (private) metadata plane. Under ``ShardedGateway`` N instances are
    built over ONE shared ``store``/``sim``/``meta`` with distinct
    ``shard_id``s: namespace maps and fault bookkeeping alias the
    plane's shared containers, fabric submissions are tagged with the
    shard's tenant lane, and cache-coherence events fan out to every
    registered shard cache through the plane."""

    def __init__(
        self,
        code: CoreCode,
        profile: ClusterProfile,
        num_nodes: int,
        config: GatewayConfig | None = None,
        *,
        store: BlockStore | None = None,
        sim: NetSimulator | None = None,
        meta: MetadataPlane | None = None,
        shard_id: int | None = None,
    ):
        self.code = code
        self.profile = profile
        self.config = config or GatewayConfig()
        self.codec = CoreCodec(code, device=self.config.device)
        # the namespace's code family: geometry + encode + degraded-read
        # candidates + repair cost surface (raises on unknown names)
        self.family = make_family(
            code, self.config.code_family, device=self.config.device
        )
        if self.config.pipeline not in (PIPELINED, SERIAL):
            raise ValueError(
                f"pipeline must be 'pipelined' or 'serial', got "
                f"{self.config.pipeline!r}"
            )
        if self.config.admission not in (ADMIT_OFF, ADMIT_REJECT, ADMIT_DEGRADE):
            raise ValueError(
                f"admission must be 'off', 'reject' or 'degrade', got "
                f"{self.config.admission!r}"
            )
        if self.config.num_engines < 1:
            raise ValueError(
                f"num_engines must be >= 1, got {self.config.num_engines}"
            )
        if self.config.coalesce not in ("ragged", "bucketed"):
            raise ValueError(
                f"coalesce must be 'ragged' or 'bucketed', got "
                f"{self.config.coalesce!r}"
            )
        if self.config.decode_cost is not None and self.config.decode_cost <= 0:
            raise ValueError(
                f"decode_cost must be positive or None (measured), got "
                f"{self.config.decode_cost}"
            )
        if self.config.encode_cost is not None and self.config.encode_cost <= 0:
            raise ValueError(
                f"encode_cost must be positive or None, got "
                f"{self.config.encode_cost}"
            )
        if self.config.decode_cost_per_tile is not None:
            if self.config.decode_cost_per_tile <= 0:
                raise ValueError(
                    f"decode_cost_per_tile must be positive or None, got "
                    f"{self.config.decode_cost_per_tile}"
                )
            if self.config.decode_cost is not None:
                raise ValueError(
                    "decode_cost and decode_cost_per_tile are mutually "
                    "exclusive timing models"
                )
            if self.config.coalesce != "ragged":
                raise ValueError(
                    "decode_cost_per_tile requires coalesce='ragged' "
                    "(bucketed launch units carry no tile counts)"
                )
        if self.config.write_coalesce not in ("ragged", "sync"):
            raise ValueError(
                f"write_coalesce must be 'ragged' or 'sync', got "
                f"{self.config.write_coalesce!r}"
            )
        if (
            self.config.repair_groups_per_run is not None
            and self.config.repair_groups_per_run < 1
        ):
            # a zero budget would requeue a continuation that never
            # repairs anything — serve() would spin forever
            raise ValueError(
                f"repair_groups_per_run must be >= 1 or None, got "
                f"{self.config.repair_groups_per_run}"
            )
        if self.config.hedge_threshold <= 0:
            raise ValueError(
                f"hedge_threshold must be positive, got "
                f"{self.config.hedge_threshold}"
            )
        if self.config.hedge_max_retries < 0:
            raise ValueError(
                f"hedge_max_retries must be >= 0, got "
                f"{self.config.hedge_max_retries}"
            )
        if self.config.hedge_backoff < 1.0:
            raise ValueError(
                f"hedge_backoff must be >= 1 (deadlines may not shrink "
                f"across retries), got {self.config.hedge_backoff}"
            )
        if self.config.hedge_budget <= 0:
            raise ValueError(
                f"hedge_budget must be positive, got {self.config.hedge_budget}"
            )
        if (
            self.config.scrub_interval is not None
            and self.config.scrub_interval <= 0
        ):
            raise ValueError(
                f"scrub_interval must be positive or None, got "
                f"{self.config.scrub_interval}"
            )
        if self.config.scrub_blocks_per_run < 1:
            raise ValueError(
                f"scrub_blocks_per_run must be >= 1, got "
                f"{self.config.scrub_blocks_per_run}"
            )
        if self.config.pipeline == SERIAL and self.config.num_engines != 1:
            # the serial baseline prices the PR-1 synchronous loop, which
            # had exactly one decode engine — extra engines would sit
            # idle while still skewing the admission estimator
            raise ValueError(
                "pipeline='serial' models a single-engine synchronous "
                f"loop; num_engines must be 1, got {self.config.num_engines}"
            )
        # sim-time observability plane (repro_torch.obs): one tracer threaded
        # through the fabric, engine pool and repair engine. NULL_TRACER
        # when disabled, so emission sites cost one attribute check.
        self.tracer = (
            Tracer(self.config.trace_sample, self.config.trace_capacity)
            if self.config.tracing
            else NULL_TRACER
        )
        # scale-out wiring: shard_id tags this gateway's fabric tenants
        # and scopes its repair ownership; store/sim/meta may be shared
        # across N shards (ShardedGateway) or private (standalone).
        self.shard_id = shard_id
        self.meta = meta if meta is not None else MetadataPlane()
        self.store = (
            store
            if store is not None
            else BlockStore(
                num_nodes=num_nodes, nodes_per_rack=self.config.nodes_per_rack
            )
        )
        if sim is not None:
            self.sim = sim
        else:
            self.sim = NetSimulator(
                profile,
                background_share=self.config.background_share,
                mode=self.config.fabric,
                tenant_weights=self.config.tenant_weights,
            )
        if sim is None or self.tracer.enabled:
            # don't clobber a shared fabric's tracer with a shard's
            # NULL_TRACER; a tracing shard may claim it explicitly
            self.sim.tracer = self.tracer
        # this shard's fabric lane for background repair ("repair@s2";
        # plain "repair" standalone). The per-shard ENGINE pool keeps
        # the base name — pools are private, lanes only matter on the
        # shared fabric.
        self._repair_tenant = shard_tenant(REPAIR_TENANT, shard_id)
        self.cache = (
            LRUBlockCache(self.config.cache_bytes, policy=self.config.cache_policy)
            if self.config.cache_bytes
            else None
        )
        self.meta.register_cache(self.cache)
        self.planner = DegradedReadPlanner(
            self.store, code, available_fn=self._available, family=self.family
        )
        self.coalescer = DecodeCoalescer(
            compute_scale=profile.compute_scale,
            device=self.config.device,
            autotune_kernels=self.config.autotune,
            mode=self.config.coalesce,
        )
        self.fixer = BlockFixer(
            self.store,
            code,
            profile,
            mode="core",
            sim=self.sim,
            priority=self._repair_tenant,
            on_block_repaired=self._on_block_repaired,
            family=self.family,
            device=self.config.device,
        )
        self.fixer.tracer = self.tracer
        # namespace maps + fault bookkeeping ALIAS the metadata plane's
        # containers (mutated in place, never rebound): every shard over
        # one plane sees one namespace. A standalone gateway's private
        # plane makes these its own state, exactly as before.
        self._objects = self.meta.objects  # object -> (group, row)
        self._groups = self.meta.groups
        self._expected = self.meta.expected  # ground truth (k, q)
        # Repaired blocks become visible only once the repair's fabric
        # transfers complete: key -> completion time of its write-back.
        self._healing = self.meta.healing
        # Cache entries to re-price once their block's heal completes —
        # re-pricing at repair time would demote a reconstruction that is
        # still the only copy reads dated before heal completion can use.
        self._reprice_on_heal = self.meta.reprice_on_heal
        # Simulated time at which each cached block came into existence
        # (fetch completion / decode completion). A cache hit may not be
        # served before it: blocks are cached at host flush time, and
        # without this gate a later window's request dated before an
        # engine-backlogged decode would read a block that does not exist
        # yet in simulated time.
        self._cache_ready: dict[BlockKey, float] = {}
        self._clock = 0.0  # logical time of the request being planned
        # Simulated decode engines: each runs one batched launch at a
        # time; launches dispatch to the least-loaded engine under the
        # owning tenant's engine share. The pool persists across windows
        # so pipelined windows overlap on it; repair decode compute is
        # billed on it too (as the "repair" tenant), so repair and
        # foreground reconstruction contend for the same engines.
        self._pool = EnginePool(
            self.config.num_engines, weights=self.config.engine_weights
        )
        self._pool.tracer = self.tracer
        # Serial-mode barrier: completion time of the previous window.
        self._window_free = 0.0
        # Scenario bookkeeping: when each currently-unavailable block was
        # lost (feeds MTTR samples on heal/recover), persisted across
        # serve() calls like _healing. Shared: a loss is a cluster fact.
        self._lost_at = self.meta.lost_at
        # groups whose missing set repair provably cannot shrink right
        # now (unrecoverable clusters): skipped by continuation runs
        # until their failure set changes
        self._repair_stuck = self.meta.repair_stuck
        # SLO-aware repair pacing: observed foreground p99 headroom
        # modulates the repair tenant's fabric weight and engine share.
        self._pacer = (
            PacingController(
                min_share=self.config.repair_min_share,
                max_share=self.config.repair_max_share,
                mttr_target=self.config.repair_mttr_target,
            )
            if self.config.repair_pacing
            else None
        )
        slos = self.config.tenant_slo_p99 or {}
        # the tier the pacer protects: the tightest declared SLO
        self._pacing_slo = min(slos.values()) if slos else None
        # -- integrity plane state ---------------------------------------------
        # background scrubber over the store (paced via the same
        # PacingController share repair uses)
        self._scrubber = Scrubber(
            self.store, blocks_per_run=self.config.scrub_blocks_per_run
        )
        self._scrub_next: float | None = self.config.scrub_interval
        # when each still-undetected silent corruption was injected —
        # omniscient metrics-only bookkeeping (detection latency); the
        # serving path itself only ever learns of corruption via verify
        self._corrupted_at = self.meta.corrupted_at
        # per-tenant hedge budget ledger: cumulative speculative fabric
        # bytes vs cumulative primary fetch bytes (the <= hedge_budget
        # structural cap), persisted across windows and serve() calls
        self._hedge_bytes: dict = {}
        self._fetch_bytes: dict = {}
        # pending detection-triggered / event-triggered repairs:
        # (due time, node | -1 continuation | -2 corruption detection)
        self._repair_queue: list[tuple[float, int]] = []
        # -- write dataplane state ---------------------------------------------
        # tombstoned objects: blocks and ground truth stay resident (the
        # group parity remains a consistent codeword — eager block
        # removal would force a parity RMW per delete) until a future GC
        # reclaims whole groups; GETs answer not-found.
        self._deleted = self.meta.deleted
        # per-tenant in-flight write work: (completion time, bytes) of
        # every PUT fabric transfer still unfinished — the admission
        # estimator's view of write pressure (GETs and PUTs both pay it)
        self._put_inflight: dict[str, list[tuple[float, float]]] = {}
        # small-object packing: lazily built (needs _block_bytes), plus
        # sealed rows awaiting a full group and the registry the sealed-
        # stripe audit walks
        self._sealer: StripeSealer | None = None
        self._pending_rows: list[tuple[int, np.ndarray, list[Extent]]] = []
        self._sealed_extents: list[Extent] = []
        self._sealed_rows: dict[int, int] = {}  # row_seq -> object id
        self._seal_group_seq = 0
        # sealed groups/objects register in the SHARED namespace, so a
        # shard's mints must not collide with a sibling's: group ids get
        # a shard infix ("w1.3") and synthetic oids a per-shard stripe
        # of the id space above SEAL_OID_BASE. Standalone stays "w3" /
        # SEAL_OID_BASE + seq exactly as before.
        self._seal_tag = "" if shard_id is None else f"{shard_id}."
        self._seal_oid_base = SEAL_OID_BASE + (
            0 if shard_id is None else shard_id << 24
        )
        # per-tile modeled billing history (admission estimator input)
        self._pt_tiles = 0
        self._pt_launches = 0

    # -- scale-out plumbing ----------------------------------------------------
    @property
    def _block_bytes(self) -> int:
        # namespace-wide (an object's geometry doesn't depend on which
        # shard serves it), so it lives on the metadata plane
        return self.meta.block_bytes

    @_block_bytes.setter
    def _block_bytes(self, value: int) -> None:
        self.meta.block_bytes = value

    def _fab_tenant(self, tenant):
        """This shard's fabric lane for a workload tenant: "gold@s1"
        under sharding, identity standalone — per-shard accounting and
        pacing on the shared fabric without changing effective weights
        (``NetSimulator.weight_of`` falls back to the base name)."""
        return shard_tenant(tenant, self.shard_id)

    # -- availability: store OR cache, gated on repair completion --------------
    def _available(self, key: BlockKey) -> bool:
        if self.cache is not None and self.cache.is_negative(key, self._clock):
            # known-down: skip the store probe entirely (negative entries
            # are purged the moment a recover event or repair write-back
            # brings the block back, and TTL-expire as a backstop); a
            # cached reconstruction still serves
            return key in self.cache
        if self.store.available(key):
            healed_at = self._healing.get(key)
            if healed_at is not None:
                if self._clock < healed_at:
                    # the repair wrote the block, but its transfers are
                    # still in flight at this request's time
                    return self.cache is not None and key in self.cache
                del self._healing[key]
                self._apply_heal_reprice(key)
            return True
        return self.cache is not None and key in self.cache

    def _on_block_repaired(self, key: BlockKey) -> None:
        # BlockFixer wrote the block back; once the write-back's fabric
        # transfers complete (the _healing gate) it is a cheap store
        # read again and any cached copy stops deserving reconstruction
        # priority. The re-price (and negative-entry purge) is deferred
        # to that simulated moment.
        self._reprice_on_heal.add(key)
        # the tombstone dies with the repair WRITE, not with the
        # node-down condition that keyed it: a corrupt-then-repaired
        # block never crashed a node, so without this purge its
        # negative entry would outlive the repair and shadow the
        # healthy store copy until TTL expiry (the _healing gate
        # keeps it invisible until the write-back lands regardless).
        # Fans out to EVERY shard's cache: a heal is a cluster fact.
        self.meta.purge_negative([key])
        # the rewrite replaces the bytes, so any still-undetected silent
        # damage is gone with them
        self._corrupted_at.pop(key, None)

    def _apply_heal_reprice(self, key: BlockKey) -> None:
        self.meta.purge_negative([key])
        if key in self._reprice_on_heal:
            self._reprice_on_heal.discard(key)
            self.meta.refresh_cost(key, 1.0)

    # -- bulk load (trace setup; not metered on the fabric) --------------------
    def load_objects(self, objects: np.ndarray) -> None:
        """objects: (num_objects, k, q) uint8. Packs objects_per_group
        objects per group (t for CORE, 1 for the row families, zero-
        padding the last group) and places all groups."""
        num, k, q = objects.shape
        if k != self.code.k:
            raise ValueError(f"objects must have k={self.code.k} blocks")
        self._block_bytes = int(q)
        t = self.family.objects_per_group
        for g0 in range(0, num, t):
            chunk = objects[g0 : g0 + t]
            if chunk.shape[0] < t:
                pad = np.zeros((t - chunk.shape[0], k, q), dtype=np.uint8)
                chunk = np.concatenate([chunk, pad], axis=0)
            gid = f"g{g0 // t}"
            matrix = self.family.encode_group(chunk).cpu().numpy()
            self.store.put_group(gid, matrix)
            members = []
            for r in range(min(t, num - g0)):
                oid = g0 + r
                self._objects[oid] = (gid, r)
                self._expected[oid] = np.asarray(objects[oid])
                members.append(oid)
            self._groups[gid] = members

    # -- serving ----------------------------------------------------------------
    def serve(
        self,
        requests: list[Request],
        failures: list | None = None,
    ) -> GatewayReport:
        """``failures`` accepts any mix of cluster events — FailureEvent
        (crash), NodeRecoverEvent, CapacityLossEvent — e.g. a
        ScenarioTrace's ``cluster_events()``. Events apply mid-run, in
        time order interleaved with the request stream, so the planner,
        negative cache, and admission controller see availability change
        between requests. While a profiler runs, the call records its
        host spans (``repro_torch.obs.host``) into ``report.metrics``."""
        report = GatewayReport(record_requests=self.config.record_requests)
        with host.recording(report.metrics, "gateway.serve"):
            self._serve(report, requests, failures)
        return report

    def _serve(self, report: GatewayReport, requests: list[Request], failures) -> None:
        cfg = self.config
        events = sorted(failures or [], key=lambda f: f.time)
        reqs = sorted(requests, key=lambda r: r.time)
        # (time, node) — on self so detection paths (_note_corrupt, fired
        # from fetch verify and scrub mid-window) can queue repairs too
        repair_queue = self._repair_queue

        fi = 0
        batch: list[Request] = []
        batch_deadline = None
        batch_kind = None  # "get" | "put" — windows are homogeneous

        def flush_open():
            nonlocal batch, batch_deadline, batch_kind
            if batch:
                if batch_kind == "put":
                    self._flush_puts(batch, report)
                else:
                    self._flush(batch, report)
            batch, batch_deadline, batch_kind = [], None, None

        def boundary_events(now: float | None):
            """Apply cluster / repair / scrub events due before ``now``
            (None => all remaining; scrub ticks stop with the request
            stream — a final drain must not scrub forever), flushing the
            open batch first."""
            nonlocal fi
            while True:
                next_evt = events[fi].time if fi < len(events) else None
                next_rep = repair_queue[0][0] if repair_queue else None
                next_scrub = self._scrub_next if now is not None else None
                cands = [
                    t for t in (next_evt, next_rep, next_scrub) if t is not None
                ]
                if not cands:
                    return
                t_evt = min(cands)
                if now is not None and t_evt > now:
                    return
                if batch and batch_deadline is not None:
                    flush_open()
                if next_evt is not None and t_evt == next_evt:
                    evt = events[fi]
                    fi += 1
                    wants_repair = self._apply_cluster_event(evt, report)
                    if wants_repair and cfg.repair_on_failure:
                        repair_queue.append((evt.time + cfg.repair_delay, evt.node))
                        repair_queue.sort()
                elif next_rep is not None and t_evt == next_rep:
                    t_rep, _node = repair_queue.pop(0)
                    if self._background_repair(t_rep, report):
                        # budgeted run left groups pending: drain the
                        # rest after the respacing interval (-1: a
                        # continuation, not a fresh failure)
                        repair_queue.append((t_rep + cfg.repair_respacing, -1))
                        repair_queue.sort()
                else:
                    self._scrub_next = t_evt + cfg.scrub_interval
                    self._run_scrub(t_evt, report)

        for req in reqs:
            boundary_events(req.time)
            if req.kind == "delete":
                # a delete is an instant metadata barrier: flush the open
                # window first so its planned (cache-pinned) reads see
                # pre-delete state, then tombstone
                flush_open()
                report.add_record(self._handle_delete(req, report))
                continue
            kind = "put" if req.kind == "put" else "get"
            # windows are HOMOGENEOUS: a kind switch closes the open
            # window (a PUT mutates blocks and parity, which must not
            # interleave with an open window's planned reads — and
            # arrival-ordered flushing is what keeps read-after-write)
            if batch and (batch_kind != kind or req.time > batch_deadline):
                flush_open()
            if not batch:
                batch_deadline = req.time + cfg.batch_window
                batch_kind = kind
            batch.append(req)
        flush_open()
        boundary_events(None)
        self._finalize_report(report)

    def _finalize_report(self, report: GatewayReport) -> None:
        """Stamp end-of-serve coalescer/autotune/tracer statistics into
        the report — shared by ``serve`` and the sharded front door's
        merged loop (which finalizes each shard's report at drain)."""
        st = self.coalescer.stats
        report.jit_cache_entries = st.jit_entries
        report.decode_launches = st.decode_calls
        report.launches_per_window = st.launches_per_window
        report.padded_byte_ratio = st.padded_byte_ratio
        # surface launch-signature churn and autotune cache behavior as
        # first-class metrics (they were only visible as raw counters)
        m = report.metrics
        m.gauge("jit_entries").set(st.jit_entries)
        m.gauge("jit_retraces").set(st.jit_retraces)
        m.gauge("encode_launches").set(st.encode_calls)
        m.gauge("encode_ops").set(st.encode_ops)
        m.gauge("encode_windows").set(st.encode_windows)
        for name, v in autotune.cache_stats().items():
            m.gauge(f"autotune_{name}").set(v)
        if self.tracer.enabled:
            for name, v in self.tracer.stats().items():
                if isinstance(v, (int, float)):
                    m.gauge(f"traces_{name}").set(v)

    # -- request batch execution ------------------------------------------------
    def _flush(self, batch: list[Request], report: GatewayReport) -> None:
        serial = self.config.pipeline == SERIAL
        tracer = self.tracer
        gets: list[tuple[Request, ReadPlan]] = []
        tids: list[int] = []  # per-get trace id, parallel to ``gets``
        # Blocks whose plans depend on the CACHE copy (store copy is
        # gone) are pinned at plan time — later fetches in this window
        # may otherwise evict them before their request executes.
        pinned: dict[BlockKey, np.ndarray] = {}
        slos = self.config.tenant_slo_p99 or {}
        with host.span("gateway.plan"):
            for req in batch:
                # serve() handles PUTs as window barriers before batching;
                # a PUT inside a window would break the pin/plan invariants
                assert req.kind == "get", f"batch may only hold GETs, got {req.kind}"
                if (
                    req.object_id not in self._objects
                    or req.object_id in self._deleted
                ):
                    report.add_record(
                        RequestRecord(
                            req.time, req.object_id, "get", None, False, 0, 0, 0,
                            tenant=req.tenant,
                        )
                    )
                    continue
                gid, row = self._objects[req.object_id]
                self._clock = req.time
                try:
                    plan = self.planner.plan(gid, row, at=req.time)
                except UnreadableObjectError:
                    report.add_record(
                        RequestRecord(
                            req.time, req.object_id, "get", None, True, 0, 0, 0,
                            tenant=req.tenant,
                        )
                    )
                    continue
                # SLO admission: estimate queue + transfer + decode time for
                # the plan; degrade mode first re-ranks the planner's
                # candidates by that estimate (a backlogged engine can make
                # the Table-1 byte-cheapest plan the latency-dearest one).
                slo = slos.get(req.tenant)
                if slo is not None and self.config.admission != ADMIT_OFF:
                    est = self._estimate_service_time(plan, req.time, req.tenant)
                    if est > slo and self.config.admission == ADMIT_DEGRADE:
                        plan, est = min(
                            (
                                (p, self._estimate_service_time(p, req.time, req.tenant))
                                for p in self.planner.candidates(gid, row, at=req.time)
                            ),
                            key=lambda pe: pe[1],
                        )
                    if est > slo:
                        report.rejections[req.tenant] = (
                            report.rejections.get(req.tenant, 0) + 1
                        )
                        report.add_record(
                            RequestRecord(
                                req.time, req.object_id, "get", None,
                                plan.degraded, 0, 0, 0,
                                tenant=req.tenant, rejected=True,
                            )
                        )
                        continue
                if self.cache is not None:
                    for key in plan.source_keys:
                        if key not in pinned and not self.store.available(key):
                            blk = self.cache.get(key)
                            if blk is not None:
                                pinned[key] = blk
                tid = 0
                if tracer.enabled:
                    tid = tracer.begin_trace()
                    tracer.instant(
                        "plan",
                        req.time,
                        tid,
                        tid,
                        track=("tenant", req.tenant),
                        degraded=plan.degraded,
                        sources=len(plan.source_keys),
                        decodes=len(plan.decodes),
                    )
                gets.append((req, plan))
                tids.append(tid)
        if not gets:
            return

        # 1) fetch: every needed block rides the fabric to the request's
        # client port, and every store fetch's crc32 digest is verified
        # on landing (config.verify_checksums). A mismatch is
        # reclassified as an ERASURE at the fetch's completion time —
        # quarantine + tombstone + repair queue — and the request
        # REPLANS against the shrunken source set (CORE parity first, RS
        # fallback), so wrong bytes never reach a payload. Direct data
        # fetches stuck behind a fail-slow source may hedge
        # (config.hedge): past the deadline derived from the healthy-
        # fabric estimate, the cheapest single-block recovery plan races
        # the primary and the first verified winner serves the column.
        # Serial mode gates the whole window's transfers on the previous
        # window's completion (the synchronous loop cannot start
        # fetching window N+1 while window N is still decoding);
        # pipelined mode starts them at plan time.
        verify_ck = self.config.verify_checksums
        ready: list[dict[BlockKey, float]] = []
        bytes_read: list[int] = []
        cache_hits: list[int] = []
        fetch_ats: list[float] = []
        alive: list[bool] = []
        fetched: dict[BlockKey, np.ndarray] = {}
        for i, (req, plan) in enumerate(gets):
            with host.span("gateway.fetch", object_id=req.object_id) as fetch_span:
                client = self._client_port(req)
                tid = tids[i]
                gid, row = self._objects[req.object_id]
                fetch_at0 = fetch_at = (
                    max(plan.planned_at, self._window_free)
                    if serial
                    else plan.planned_at
                )
                # SLO tenants stamp their fabric transfers with a deadline so
                # the simulator's per-tenant miss counters line up with the
                # report's violation rates.
                deadline = (
                    req.time + slos[req.tenant] if req.tenant in slos else None
                )
                key_ready: dict[BlockKey, float] = {}
                nbytes = 0
                hits = 0
                hedges = 0
                n_store = 0  # store fetches scheduled for THIS request
                extra_ops: list = []
                dropped_direct: set[BlockKey] = set()
                ok_request = True
                trk = ("tenant", req.tenant)
                # Replan loop: terminates because every corruption detection
                # permanently quarantines a source (the replan never picks it
                # again); the attempt cap is pure defense in depth.
                for _attempt in range(self.code.n * self.family.rows + 1):
                    corrupt: list[tuple[BlockKey, float]] = []
                    stale = False
                    # direct fetches eligible to hedge; the DECISION is
                    # deferred until every primary of this attempt is booked,
                    # so the alternate path can reuse the whole in-flight
                    # fetch set for free
                    h_cands: list[tuple[BlockKey, float, int, float]] = []
                    for key in plan.source_keys:
                        if key in key_ready:
                            continue
                        blk = pinned.get(key)
                        if blk is None and self.cache is not None:
                            blk = self.cache.get(key)
                        if blk is not None:
                            # cache copies were digest-verified when they
                            # entered (fetch path) or checked post-decode —
                            # no re-verify: checksumming models DISK reads
                            key_ready[key] = max(
                                fetch_at, self._cache_ready.get(key, 0.0)
                            )
                            hits += 1
                            if tracer.enabled:
                                tracer.instant(
                                    "cache.hit",
                                    key_ready[key],
                                    tid,
                                    tid,
                                    track=trk,
                                    key=key,
                                )
                            fetched[key] = blk
                            continue
                        if not self.store.available(key):
                            # quarantined by an earlier request of this same
                            # window: nothing to fetch, the replan below
                            # routes around it
                            stale = True
                            continue
                        blk = self.store.get(key)
                        src_node = self.store.node_of(key)
                        # committed backlog BEFORE this transfer books its
                        # own reservation: the hedge deadline must measure
                        # the fabric as the request found it
                        pre_backlog = (
                            self.sim.send_backlog(
                                src_node, self._fab_tenant(req.tenant), fetch_at
                            )
                            if self.config.hedge and key in plan.direct
                            else None
                        )
                        n_store += 1
                        end = self.sim.transfer(
                            Transfer(
                                src_node,
                                client,
                                blk.nbytes,
                                fetch_at,
                                tenant=self._fab_tenant(req.tenant),
                                deadline=deadline,
                                ctx=(tid, tid) if tracer.enabled else None,
                            )
                        )
                        nbytes += blk.nbytes
                        self._fetch_bytes[req.tenant] = (
                            self._fetch_bytes.get(req.tenant, 0) + blk.nbytes
                        )
                        if verify_ck and not self.store.verify(key):
                            # corrupt bytes crossed the fabric and failed
                            # the digest check on landing — never cached,
                            # never delivered
                            corrupt.append((key, end))
                            continue
                        if pre_backlog is not None:
                            h_cands.append((key, pre_backlog, n_store, end))
                        key_ready[key] = end
                        fetched[key] = blk
                        if self.cache is not None:
                            self.cache.put(key, blk)
                            self._cache_ready[key] = end
                        if tracer.enabled:
                            # request-side view: includes fabric queueing
                            # (the port-track xfer span shows the transfer
                            # itself, from its first byte)
                            tracer.span(
                                "fetch",
                                fetch_at,
                                end,
                                tid,
                                tid,
                                track=trk,
                                key=key,
                                src=src_node,
                                bytes=blk.nbytes,
                            )
                    # Deadline baseline: the LEAST-backlogged source this
                    # request fetched from. A fail-slow port's own committed
                    # queue is stretched by the very slowness being detected,
                    # so pricing each candidate against its own backlog would
                    # let a gray source re-baseline its own deadline into
                    # oblivion; the cross-source differential is the signal.
                    base_b = min((b for _, b, _, _ in h_cands), default=0.0)
                    for h_key, _pre_b, n_at, h_end in h_cands:
                        if hedges >= self.config.hedge_max_retries:
                            break
                        h_op, h_bytes, h_hits, launched = self._maybe_hedge(
                            req, h_key, fetch_at, base_b, n_at, h_end, hedges,
                            client, deadline, key_ready, fetched, pinned,
                            report, tid, trk,
                        )
                        nbytes += h_bytes
                        hits += h_hits
                        if launched:
                            hedges += 1
                        if h_op is not None:
                            extra_ops.append(h_op)
                            dropped_direct.add(h_key)
                    if not corrupt and not stale:
                        break
                    detect_at = max((e for _, e in corrupt), default=fetch_at)
                    for key, at in corrupt:
                        self._note_corrupt(
                            key,
                            at,
                            report,
                            source="read",
                            ctx=(tid, tid, trk) if tracer.enabled else None,
                        )
                    # the degraded replan starts when the LAST bad fetch of
                    # this round landed — detection costs real latency
                    self._clock = fetch_at = max(detect_at, fetch_at)
                    try:
                        plan = self.planner.plan(gid, row, at=fetch_at)
                    except UnreadableObjectError:
                        ok_request = False
                        break
                if ok_request and (extra_ops or dropped_direct):
                    plan = replace(
                        plan,
                        direct=tuple(
                            k for k in plan.direct if k not in dropped_direct
                        ),
                        decodes=plan.decodes + tuple(extra_ops),
                    )
                gets[i] = (req, plan)
                if not ok_request:
                    # corruption detections mid-window pushed the object past
                    # tolerance: fail the read (bytes already moved are real)
                    report.add_record(
                        RequestRecord(
                            req.time, req.object_id, "get", None, True,
                            nbytes, 0, hits, tenant=req.tenant,
                        )
                    )
                    if tracer.enabled:
                        tracer.end_trace(tid)
                fetch_span.nbytes = nbytes
                alive.append(ok_request)
                ready.append(key_ready)
                bytes_read.append(nbytes)
                cache_hits.append(hits)
                fetch_ats.append(fetch_at0)

        # 2) decode: dedup identical reconstructions (a hot degraded
        # object appears once per window, not once per request), then one
        # stacked launch per shape bucket, scheduled on the simulated
        # serial decode engine.
        unique_idx: dict[tuple, int] = {}
        uops = []
        owners: list[list[int]] = []
        for i, (_req, plan) in enumerate(gets):
            if not alive[i]:
                continue
            for op in plan.decodes:
                okey = (op.group_id, op.row, op.kind, op.targets, op.sources)
                j = unique_idx.get(okey)
                if j is None:
                    j = len(uops)
                    unique_idx[okey] = j
                    uops.append(op)
                    owners.append([])
                owners[j].append(i)
        results, units = self.coalescer.execute(uops, lambda k: fetched[k])
        if verify_ck:
            # end-to-end integrity: a reconstruction must reproduce the
            # digest stored at PUT. Sources are verified at fetch time,
            # so a mismatch here means the decode pipeline itself (or an
            # unverified path feeding it) produced wrong bytes — a bug,
            # not a modeled fault.
            checked = sum(out.nbytes for r in results for out in r.values())
            with host.span("gateway.decode_check", checked):
                for j, op in enumerate(uops):
                    for col, out in results[j].items():
                        if self.store.checksum_ok((op.group_id, op.row, col), out) is False:
                            raise AssertionError(
                                "decode output digest mismatch for block "
                                f"({op.group_id}, {op.row}, {col})"
                            )
        if self.config.decode_cost_per_tile is not None:
            # throughput-bound modeled billing: a unit costs its tile
            # count, so splitting the op stream into more/smaller
            # launches does not change the cluster's total billed work
            units = [
                replace(u, compute=self.config.decode_cost_per_tile * u.tiles)
                for u in units
            ]
            # rolling tiles-per-launch average for the admission
            # estimator (billed work, not measured wall time)
            self._pt_tiles += sum(u.tiles for u in units)
            self._pt_launches += len({(u.kind, u.launch_id) for u in units})
        elif self.config.decode_cost is not None:
            # modeled-cost mode: deterministic billing — each unit gets
            # its FRACTION of one modeled launch, so a launch's units
            # still sum to exactly decode_cost regardless of dataplane
            units = [
                replace(u, compute=self.config.decode_cost * u.fraction)
                for u in units
            ]
        # a unit bills its engine time to the tenant of the earliest
        # request that owns one of its ops (a unit has exactly one
        # engine reservation, so it needs exactly one payer)
        op_ready: list[float] = [
            max(ready[i][s] for i in owners[j] for s in op.sources)
            for j, op in enumerate(uops)
        ]
        op_tenant: list[str] = [
            gets[owners[j][0]][0].tenant for j in range(len(uops))
        ]
        op_done: list[float] = [0.0] * len(uops)
        # per-op launch attribution for the critical-path analyzer: the
        # dispatch interval of the unit that COMPLETED the op (its max
        # end), plus the launch-wide source barrier it waited behind
        op_meta: list[dict | None] = [None] * len(uops)
        if serial:
            # strict staging: no launch before ALL the window's transfers
            # (even direct-only fetches) complete; launches back-to-back
            # on ONE engine (the synchronous loop this baseline prices
            # had no decode parallelism); the whole window waits for the
            # last launch.
            window_net = max(
                (t for key_ready in ready for t in key_ready.values()),
                default=self._window_free,
            )
            if units:
                total = sum(u.compute for u in units)
                start, end = self._pool.dispatch(
                    window_net,
                    total,
                    ctx=(
                        (tids[0], tids[0], {"kind": "serial", "launch_id": -1})
                        if tracer.enabled
                        else None
                    ),
                )
                op_done = [end] * len(uops)
                op_meta = [
                    {
                        "start": start,
                        "end": end,
                        "ready": window_net,
                        "kind": "serial",
                        "launch_id": -1,
                        "fraction": 1.0,
                        "tiles": 0,
                    }
                ] * len(uops)
        else:
            # pipelined: a PHYSICAL launch cannot start before every
            # source staged into it lands (its buffer holds all its
            # ops' tiles), so all units sharing a launch_id wait for
            # the launch-wide barrier; past it they dispatch
            # independently, in arrival order, onto the least-loaded
            # decode engine under the owning tenant's engine share —
            # windows (and one megakernel launch's per-op tile ranges)
            # overlap across the engine pool
            launch_ready: dict[int, float] = {}
            for u in units:
                r = max(op_ready[j] for j in u.op_indices)
                launch_ready[u.launch_id] = max(
                    launch_ready.get(u.launch_id, 0.0), r
                )
            for u in sorted(units, key=lambda u: launch_ready[u.launch_id]):
                ctx = None
                if tracer.enabled:
                    # bill the engine-track span to the trace of the
                    # earliest request owning this unit's first op (the
                    # same owner the engine time is billed to)
                    ctx = (
                        tids[owners[u.op_indices[0]][0]],
                        tids[owners[u.op_indices[0]][0]],
                        {"kind": u.kind, "launch_id": u.launch_id},
                    )
                start, end = self._pool.dispatch(
                    launch_ready[u.launch_id], u.compute,
                    tenant=op_tenant[u.op_indices[0]],
                    ctx=ctx,
                )
                for j in u.op_indices:
                    if end >= op_done[j]:
                        op_done[j] = end
                        op_meta[j] = {
                            "start": start,
                            "end": end,
                            "ready": launch_ready[u.launch_id],
                            "kind": u.kind,
                            "launch_id": u.launch_id,
                            "fraction": u.fraction,
                            "tiles": u.tiles,
                        }

        # 3) verify + deliver
        decoded_per_req: list[dict[int, np.ndarray]] = [dict() for _ in gets]
        for j, op in enumerate(uops):
            for i in owners[j]:
                decoded_per_req[i].update(results[j])
        # rebuild cost of a decoded block = source blocks its op consumed
        # (t vertical, k horizontal) — the cache's eviction currency
        decode_cost: dict[int, dict[int, int]] = {}
        for j, op in enumerate(uops):
            for i in owners[j]:
                costs = decode_cost.setdefault(i, {})
                for col in op.targets:
                    costs[col] = len(op.sources)
        window_end = self._window_free
        for i, (req, plan) in enumerate(gets):
            if not alive[i]:
                continue
            done = req.time
            for key in plan.direct:
                done = max(done, ready[i][key])
            for op in plan.decodes:
                okey = (op.group_id, op.row, op.kind, op.targets, op.sources)
                done = max(done, op_done[unique_idx[okey]])
            digest = None
            if self.config.verify or self.config.record_payloads:
                with host.span("gateway.assemble", object_id=req.object_id) as sp:
                    payload = self._assemble_payload(req, plan, fetched, decoded_per_req[i])
                    sp.nbytes = payload.nbytes
                if self.config.verify:
                    self._verify_get(req, payload)
                    report.metrics.counter("verified_gets").inc()
                if self.config.record_payloads:
                    with host.span("gateway.sha256", payload.nbytes, object_id=req.object_id):
                        digest = hashlib.sha256(payload.tobytes()).hexdigest()
            if self.cache is not None:
                gid, row = self._objects[req.object_id]
                costs = decode_cost.get(i, {})
                col_done = {
                    col: op_done[
                        unique_idx[
                            (op.group_id, op.row, op.kind, op.targets, op.sources)
                        ]
                    ]
                    for op in plan.decodes
                    for col in op.targets
                }
                for col, blk in decoded_per_req[i].items():
                    ckey = (gid, row, col)
                    self.cache.put(ckey, blk, cost=costs.get(col, 1.0))
                    self._cache_ready[ckey] = col_done.get(col, done)
            if tracer.enabled:
                tid = tids[i]
                for op in plan.decodes:
                    okey = (op.group_id, op.row, op.kind, op.targets, op.sources)
                    j = unique_idx[okey]
                    meta = op_meta[j]
                    if meta is None:
                        continue
                    tracer.span(
                        "decode",
                        meta["start"],
                        meta["end"],
                        tid,
                        tid,
                        track=("tenant", req.tenant),
                        op=j,
                        shared=len(owners[j]),
                        op_ready=max(ready[i][s] for s in op.sources),
                        **{
                            k: meta[k]
                            for k in ("ready", "kind", "launch_id", "fraction", "tiles")
                        },
                    )
                if self.config.verify:
                    tracer.instant(
                        "verify", done, tid, tid, track=("tenant", req.tenant)
                    )
                tracer.root_span(
                    "request",
                    req.time,
                    done,
                    tid,
                    track=("tenant", req.tenant),
                    object_id=req.object_id,
                    kind="get",
                    tenant=req.tenant,
                    degraded=plan.degraded,
                    bytes=bytes_read[i],
                    cache_hits=cache_hits[i],
                    fetch_at=fetch_ats[i],
                )
                tracer.end_trace(tid, latency=done - req.time)
            report.add_record(
                RequestRecord(
                    req.time,
                    req.object_id,
                    "get",
                    done - req.time,
                    plan.degraded,
                    bytes_read[i],
                    plan.reconstruction_blocks,
                    cache_hits[i],
                    payload_digest=digest,
                    tenant=req.tenant,
                )
            )
            window_end = max(window_end, done)
        if serial:
            self._window_free = window_end

    # -- integrity plane ---------------------------------------------------------
    def _note_corrupt(
        self,
        key: BlockKey,
        at: float,
        report: GatewayReport,
        source: str,
        ctx=None,
        queue_repair: bool = True,
    ) -> None:
        """Reclassify a detected corruption as an ERASURE: quarantine the
        replica (placement and the trusted digest survive — repair can
        verify its own rebuild), tombstone it in the negative cache so
        planners stop probing it, and queue a repair pass. ``source``
        labels the detector (read | scrub | write | repair)."""
        self.store.quarantine(key)
        self._lost_at.setdefault(key, at)
        # any in-flight heal write-back raced the corruption; distrust it
        self._healing.pop(key, None)
        # tombstone in EVERY shard's negative cache — another shard may
        # hold this block's key in a read plan it has yet to execute
        self.meta.put_negative(key, at, self.config.negative_ttl)
        report.metrics.counter("corruption_detected", source=source).inc()
        t0 = self._corrupted_at.pop(key, None)
        if t0 is not None:
            # injection-to-detection gap: the integrity plane's MTTD
            report.corruption_latency.append(at - t0)
        if queue_repair and self.config.repair_on_failure:
            self._repair_queue.append((at + self.config.repair_delay, -2))
            self._repair_queue.sort()
        if ctx is not None:
            tid, pid, trk = ctx
            self.tracer.instant(
                "corrupt", at, tid, pid, track=trk, key=key, source=source
            )

    def _run_scrub(self, at: float, report: GatewayReport) -> None:
        """One background scrub tick: verify a budget's worth of resident
        blocks against their stored digests, reclassifying mismatches as
        erasures. The budget rides the repair pacer's share so scrubbing
        backs off exactly when foreground latency is under pressure."""
        share = 1.0
        if self._pacer is not None:
            observed = self._observed_p99(report, at)
            pressure = self._foreground_pressure(at)
            if pressure > 0.0:
                observed = max(observed or 0.0, pressure)
            share = self._pacer.share(observed, self._pacing_slo)
        budget = max(1, int(self.config.scrub_blocks_per_run * share))
        bad = self._scrubber.scan(budget)
        report.metrics.counter("scrub_blocks").inc(budget)
        tracer = self.tracer
        stid = 0
        if tracer.enabled:
            stid = tracer.begin_trace()
        for key in bad:
            self._note_corrupt(
                key,
                at,
                report,
                source="scrub",
                ctx=(stid, stid, ("repair", "repair")) if stid else None,
            )
        if stid:
            tracer.root_span(
                "scrub.run",
                at,
                at,
                stid,
                track=("repair", "repair"),
                scanned=min(budget, len(self.store.blocks)),
                found=len(bad),
            )
            tracer.end_trace(stid)

    def _maybe_hedge(
        self,
        req,
        key: BlockKey,
        fetch_at: float,
        pre_backlog: float,
        n_store: int,
        end: float,
        hedges: int,
        client: int,
        deadline: float | None,
        key_ready: dict,
        fetched: dict,
        pinned: dict,
        report: GatewayReport,
        tid: int,
        trk,
    ):
        """Race a slow direct fetch against the planner's cheapest
        single-block recovery op. Returns ``(op, bytes, hits, launched)``
        — ``op`` is the winning DecodeOp to splice into the plan (None:
        deadline not hit, no viable op, out of budget, or the primary
        won the race anyway).

        The hedge deadline is ``hedge_threshold x`` the HEALTHY-fabric
        estimate: ``pre_backlog`` is the committed backlog of the
        request's LEAST-backlogged source (the caller computes the min
        across its fetch set), plus serialization at the tenant's
        guaranteed rate. A fail-slow port's own queue is stretched by
        the very slowness being detected, so the estimate never reads
        the lagging source's backlog — the degraded fetch shows up as
        ``end >> estimate`` instead of quietly re-baselining its own
        deadline. Speculative bytes are capped
        by a per-tenant ledger at ``hedge_budget`` of the tenant's
        cumulative primary fetch bytes — the extra-fabric-traffic bound
        is structural, not observed."""
        cfg = self.config
        tenant = req.tenant
        # expected completion of THIS fetch on a healthy fabric: source
        # backlog + the request's own client-NIC serialization so far
        # (n_store store fetches, this one included, share the client
        # port) — self-inflicted queueing is NOT gray failure and must
        # not trip the hedge
        est = pre_backlog + n_store * self._block_bytes / (
            self.sim.weight_of(tenant) * self.profile.node_bandwidth
        )
        h_at = fetch_at + cfg.hedge_threshold * (cfg.hedge_backoff ** hedges) * est
        if end <= h_at:
            return None, 0, 0, False
        gid, row, col = key
        self._clock = h_at
        # Rank alternate paths by NEW fetch bytes, not Table-1 totals: a
        # horizontal op whose row sources are already riding this
        # request's fabric costs one parity fetch, while the "cheaper"
        # vertical op fetches t fresh column blocks. Disqualify any path
        # that routes new fetches through the lagging source's node —
        # under column-aligned placement the vertical sources can share
        # the stuck column's node, making the byte-cheapest op the one
        # op guaranteed to lose the race.
        lagging = self.store.node_of(key)
        op = None
        h_cost = 0
        for cand in self.planner.recovery_ops(gid, row, col):
            fresh = [
                s
                for s in cand.sources
                if s not in key_ready
                and s not in pinned
                and not (self.cache is not None and s in self.cache)
            ]
            if any(self.store.node_of(s) == lagging for s in fresh):
                continue
            cost = len(fresh) * self._block_bytes
            if op is None or cost < h_cost:
                op, h_cost = cand, cost
        if op is None:
            return None, 0, 0, False
        spent = self._hedge_bytes.get(tenant, 0)
        if spent + h_cost > cfg.hedge_budget * self._fetch_bytes.get(tenant, 0):
            report.metrics.counter("hedge_budget_denied", tenant=tenant).inc()
            return None, 0, 0, False
        report.metrics.counter("hedge_launched", tenant=tenant).inc()
        nbytes = 0
        hits = 0
        h_ready = h_at
        ok = True
        for s in op.sources:
            if s in key_ready:
                # already riding the fabric for this request — free
                h_ready = max(h_ready, key_ready[s])
                continue
            sblk = pinned.get(s)
            if sblk is None and self.cache is not None:
                sblk = self.cache.get(s)
            if sblk is not None:
                r = max(h_at, self._cache_ready.get(s, 0.0))
                key_ready[s] = r
                fetched[s] = sblk
                hits += 1
                h_ready = max(h_ready, r)
                continue
            if not self.store.available(s):
                ok = False
                break
            sblk = self.store.get(s)
            s_end = self.sim.transfer(
                Transfer(
                    self.store.node_of(s),
                    client,
                    sblk.nbytes,
                    h_at,
                    tenant=self._fab_tenant(tenant),
                    deadline=deadline,
                    ctx=(tid, tid) if self.tracer.enabled else None,
                )
            )
            nbytes += sblk.nbytes
            self._hedge_bytes[tenant] = (
                self._hedge_bytes.get(tenant, 0) + sblk.nbytes
            )
            if cfg.verify_checksums and not self.store.verify(s):
                # the speculation tripped over latent damage: quarantine
                # it and abandon this hedge (the primary still serves)
                self._note_corrupt(
                    s,
                    s_end,
                    report,
                    source="read",
                    ctx=(tid, tid, trk) if self.tracer.enabled else None,
                )
                ok = False
                break
            key_ready[s] = s_end
            fetched[s] = sblk
            if self.cache is not None:
                self.cache.put(s, sblk)
                self._cache_ready[s] = s_end
            h_ready = max(h_ready, s_end)
        won = ok and (h_ready + self._decode_launch_estimate() < end)
        report.metrics.counter(
            "hedge_wins" if won else "hedge_losses", tenant=tenant
        ).inc()
        if nbytes:
            report.metrics.counter("hedge_bytes", tenant=tenant).inc(nbytes)
        if self.tracer.enabled:
            self.tracer.span(
                "hedge",
                h_at,
                max(h_ready, h_at),
                tid,
                tid,
                track=trk,
                key=key,
                kind=op.kind,
                won=won,
                attempt=hedges + 1,
            )
        return (op if won else None), nbytes, hits, True

    # -- write dataplane ---------------------------------------------------------
    def _handle_delete(
        self, req: Request, report: GatewayReport
    ) -> RequestRecord:
        """Tombstone an object. Blocks and ground truth stay resident
        (the group parity remains a consistent codeword — eager block
        removal would force a parity RMW per delete); a later overwrite
        PUT resurrects the object in place. A delete is pure metadata:
        zero fabric traffic, acknowledged instantly."""
        oid = req.object_id
        known = oid in self._objects and oid not in self._deleted
        if known:
            self._deleted.add(oid)
            report.metrics.counter("deletes", tenant=req.tenant).inc()
        return RequestRecord(
            req.time, oid, "delete", 0.0 if known else None, False, 0, 0, 0,
            tenant=req.tenant,
        )

    def _flush_puts(self, batch: list[Request], report: GatewayReport) -> None:
        """One PUT window: admission, small-object journaling/sealing,
        then the window's encodes — ONE ragged ENCODE megakernel window
        for the whole batch (``write_coalesce="ragged"``) or one per PUT
        (``"sync"``, the synchronous write baseline)."""
        cfg = self.config
        slos = cfg.tenant_slo_p99 or {}
        full_reqs: list[Request] = []
        small_reqs: list[Request] = []
        for req in batch:
            assert req.kind == "put", f"put batch may only hold PUTs, got {req.kind}"
            self._clock = req.time
            if req.nbytes is None and req.object_id not in self._objects:
                report.add_record(
                    RequestRecord(
                        req.time, req.object_id, "put", None, False, 0, 0, 0,
                        tenant=req.tenant,
                    )
                )
                continue
            # SLO admission: writes are admitted against the tenant's
            # in-flight write backlog + this PUT's own bytes + (full
            # overwrites) the encode-engine wait — the same currency the
            # GET estimator charges, so writes and reads push back on
            # each other instead of writes riding for free
            slo = slos.get(req.tenant)
            if slo is not None and cfg.admission != ADMIT_OFF:
                est = self._estimate_put_time(req, req.time)
                if est > slo:
                    report.put_rejections[req.tenant] = (
                        report.put_rejections.get(req.tenant, 0) + 1
                    )
                    report.add_record(
                        RequestRecord(
                            req.time, req.object_id, "put", None, False, 0,
                            0, 0, tenant=req.tenant, rejected=True,
                        )
                    )
                    continue
            (small_reqs if req.nbytes is not None else full_reqs).append(req)
        seal_groups = self._append_small(small_reqs, report)
        jobs: list[dict] = []
        cur: dict[int, np.ndarray] = {}  # same-oid overwrite chains
        for req in full_reqs:
            oid = req.object_id
            gid, row = self._objects[oid]
            rng = np.random.default_rng(
                (oid * 1_000_003 + int(req.time * 1e6)) % (2**63)
            )
            new_data = rng.integers(
                0, 256, (self.code.k, self._block_bytes), dtype=np.uint8
            )
            # Delta against the re-encoded OLD row (ground truth), not
            # the stored block — a lost old block must still contribute
            # its delta or the vertical parity goes stale for the whole
            # column. Within a window, chained overwrites of one object
            # delta against the PREVIOUS overwrite in arrival order.
            old_data = cur.get(oid, self._expected[oid])
            cur[oid] = new_data
            jobs.append(
                {
                    "req": req,
                    "oid": oid,
                    "gid": gid,
                    "row": row,
                    "new_data": new_data,
                    "old_data": old_data,
                    "enc_done": req.time,
                }
            )
        if cfg.write_coalesce == "ragged":
            windows = [(jobs, seal_groups)] if (jobs or seal_groups) else []
        else:
            windows = [([j], []) for j in jobs]
            windows += [([], [g]) for g in seal_groups]
        for wjobs, wseals in windows:
            self._encode_window(wjobs, wseals, report)

    def _append_small(
        self, reqs: list[Request], report: GatewayReport
    ) -> list[dict]:
        """Journal and pack small PUTs (stripe sealing). The journal
        append IS the ack: the payload rides the fabric to a
        deterministic journal node and the PUT completes when it lands —
        sealing and encoding happen behind the ack. Returns the seal
        groups (``objects_per_group`` sealed rows each) this window
        completed, ready for _encode_window."""
        groups: list[dict] = []
        t = self.family.objects_per_group
        tracer = self.tracer
        for req in reqs:
            if self._sealer is None:
                self._sealer = StripeSealer(self.code.k, self._block_bytes)
            nb = max(1, min(int(req.nbytes), self._sealer.row_bytes))
            rng = np.random.default_rng(
                (req.object_id * 1_000_003 + int(req.time * 1e6) + nb)
                % (2**63)
            )
            payload = rng.integers(0, 256, nb, dtype=np.uint8)
            small_id = (req.object_id, round(req.time, 9))
            self._pending_rows.extend(
                self._sealer.append(small_id, payload, req.tenant)
            )
            while len(self._pending_rows) >= t:
                rows = self._pending_rows[:t]
                del self._pending_rows[:t]
                gid = f"w{self._seal_tag}{self._seal_group_seq}"
                self._seal_group_seq += 1
                groups.append(
                    {
                        "gid": gid,
                        "rows": rows,
                        "time": req.time,
                        "tenant": req.tenant,
                        "enc_done": req.time,
                    }
                )
            jnode = zlib.crc32(repr(small_id).encode()) % self.store.num_nodes
            tid = tracer.begin_trace() if tracer.enabled else 0
            end = self.sim.transfer(
                Transfer(
                    self._client_port(req),
                    jnode,
                    nb,
                    req.time,
                    tenant=self._fab_tenant(req.tenant),
                    ctx=(tid, tid) if tracer.enabled else None,
                )
            )
            self._put_inflight.setdefault(req.tenant, []).append(
                (end, float(nb))
            )
            report.metrics.counter("small_puts", tenant=req.tenant).inc()
            if tracer.enabled:
                tracer.root_span(
                    "request",
                    req.time,
                    end,
                    tid,
                    track=("tenant", req.tenant),
                    object_id=req.object_id,
                    kind="put",
                    tenant=req.tenant,
                    degraded=False,
                    bytes=nb,
                    cache_hits=0,
                    fetch_at=req.time,
                )
                tracer.end_trace(tid, latency=end - req.time)
            report.add_record(
                RequestRecord(
                    req.time, req.object_id, "put", end - req.time, False,
                    nb, 0, 0, tenant=req.tenant,
                )
            )
        return groups

    def _dispatch_encode_units(
        self, units, op_ready, op_tenant, op_tid, model_cost
    ) -> list[float]:
        """Dispatch one encode phase's LaunchUnits on the shared engine
        pool under the decode path's exact conventions: modeled-cost
        override scaled by each unit's launch fraction, launch-wide
        readiness barrier (a physical launch's staging buffer holds
        every op's tiles), owner-tenant billing. Returns per-op
        completion times."""
        op_done = list(op_ready)
        if not units:
            return op_done
        if model_cost is not None:
            units = [
                replace(u, compute=model_cost * u.fraction) for u in units
            ]
        launch_ready: dict[int, float] = {}
        for u in units:
            r = max(op_ready[j] for j in u.op_indices)
            launch_ready[u.launch_id] = max(
                launch_ready.get(u.launch_id, 0.0), r
            )
        tracer = self.tracer
        for u in sorted(units, key=lambda u: launch_ready[u.launch_id]):
            j0 = u.op_indices[0]
            ctx = None
            if tracer.enabled and op_tid[j0]:
                ctx = (
                    op_tid[j0],
                    op_tid[j0],
                    {"kind": u.kind, "launch_id": u.launch_id},
                )
            _start, end = self._pool.dispatch(
                launch_ready[u.launch_id],
                u.compute,
                tenant=op_tenant[j0],
                ctx=ctx,
            )
            for j in u.op_indices:
                op_done[j] = max(op_done[j], end)
        return op_done

    def _encode_window(
        self, jobs: list[dict], seals: list[dict], report: GatewayReport
    ) -> None:
        """Execute one write ENCODE window end to end.

        Phase EH (ops.gf256_ragged_encode): every full overwrite
        re-encodes its NEW data and re-derives its OLD row's parity
        columns through the RS generator, and every sealing row
        generates its parity columns — all in ONE ragged megakernel
        launch. Phase EV (ops.xor_ragged_encode): ONE fold op per parity
        block the window touches (XOR associativity folds every
        contributing PUT's old^new delta and the stored parity in a
        single op) plus the sealing groups' vertical parity columns —
        again one launch. Both phases are billed on the SHARED engine
        pool (modeled ``encode_cost`` / ``decode_cost`` or measured
        best-observed kernel time, exactly like decode), and each PUT's
        client transfers start only once its encodes land — encoded
        bytes cannot ride the fabric before they exist.

        The parity read-modify-write verifies the stored digest BEFORE
        folding: XOR-ing into silently-corrupt bytes and restamping
        would LAUNDER the corruption under a fresh valid checksum. A
        corrupt parity block is treated like an unavailable one —
        quarantined and reconciled by repair."""
        if not jobs and not seals:
            return
        cfg = self.config
        n, k, q = self.code.n, self.code.k, self._block_bytes
        has_parity = self.family.rows > 1
        parity_row = self.family.rows - 1
        model_cost = (
            cfg.encode_cost if cfg.encode_cost is not None else cfg.decode_cost
        )
        tracer = self.tracer
        pool: dict = {}  # staging tokens -> host arrays (the fetch oracle)
        for job in jobs:
            job["tid"] = tracer.begin_trace() if tracer.enabled else 0
        for seal in seals:
            seal["tid"] = tracer.begin_trace() if tracer.enabled else 0
            seal["matrix"] = np.zeros(
                (self.family.rows, n, q), dtype=np.uint8
            )
            for r, (_seq, row_data, _exts) in enumerate(seal["rows"]):
                seal["matrix"][r, :k] = row_data

        # ---- phase EH: RS parity-row generation ------------------------------
        eh_ops: list[DecodeOp] = []
        eh_owner: list[tuple] = []
        eh_ready: list[float] = []
        eh_tenant: list[str] = []
        eh_tid: list[int] = []
        if has_parity:
            pmat = rs.parity_matrix(n, k)
            par_targets = tuple(range(k, n))

            def stage_eh(tok0, data, gid, row, owner, at, tenant, tid):
                srcs = []
                for i in range(k):
                    tok = tok0 + (i,)
                    pool[tok] = data[i]
                    srcs.append(tok)
                eh_ops.append(
                    DecodeOp("EH", gid, row, par_targets, tuple(srcs), pmat)
                )
                eh_owner.append(owner)
                eh_ready.append(at)
                eh_tenant.append(tenant)
                eh_tid.append(tid)

            for ji, job in enumerate(jobs):
                for tag in ("new", "old"):
                    stage_eh(
                        ("j", ji, tag),
                        job[f"{tag}_data"],
                        job["gid"],
                        job["row"],
                        ("job", ji, tag),
                        job["req"].time,
                        job["req"].tenant,
                        job["tid"],
                    )
            for si, seal in enumerate(seals):
                for r in range(len(seal["rows"])):
                    stage_eh(
                        ("s", si, r),
                        seal["matrix"][r, :k],
                        seal["gid"],
                        r,
                        ("seal", si, r),
                        seal["time"],
                        seal["tenant"],
                        seal["tid"],
                    )
        eh_results, eh_units = self.coalescer.execute_encode(
            eh_ops, pool.__getitem__
        )
        eh_done = self._dispatch_encode_units(
            eh_units, eh_ready, eh_tenant, eh_tid, model_cost
        )
        for oi, owner in enumerate(eh_owner):
            out = eh_results[oi]
            if owner[0] == "job":
                _o, ji, tag = owner
                job = jobs[ji]
                rowbuf = np.empty((n, q), dtype=np.uint8)
                rowbuf[:k] = job[f"{tag}_data"]
                for col, arr in out.items():
                    rowbuf[col] = arr
                job[f"{tag}_row"] = rowbuf
                job["enc_done"] = max(job["enc_done"], eh_done[oi])
            else:
                _o, si, r = owner
                for col, arr in out.items():
                    seals[si]["matrix"][r, col] = arr
                seals[si]["enc_done"] = max(
                    seals[si]["enc_done"], eh_done[oi]
                )
        if has_parity and cfg.verify:
            # kernel-vs-oracle: the ragged EH output must equal the host
            # generator exactly — wrong encodes may never reach a disk
            for job in jobs:
                want = (
                    self.code.horizontal.encode(job["new_data"], self.config.device)
                    .cpu()
                    .numpy()
                )
                if not np.array_equal(job["new_row"], want):
                    raise AssertionError(
                        f"ragged encode mismatch for object {job['oid']}"
                    )
        if not has_parity:
            # row families (rs / lrc): the object IS the whole codeword
            # row — encode through the family generator host-side and
            # bill one modeled launch per overwrite / seal on the pool
            dur = (
                model_cost
                if model_cost is not None
                else self._encode_launch_estimate()
            )
            for job in jobs:
                job["new_row"] = (
                    self.family.encode_group(job["new_data"][None]).cpu().numpy()[0]
                )
                job["old_row"] = None
                if dur > 0.0:
                    _s, end = self._pool.dispatch(
                        job["req"].time, dur, tenant=job["req"].tenant
                    )
                    job["enc_done"] = max(job["enc_done"], end)
            for seal in seals:
                objs = np.stack([rd for (_sq, rd, _x) in seal["rows"]])
                seal["matrix"] = self.family.encode_group(objs).cpu().numpy()
                if dur > 0.0:
                    _s, end = self._pool.dispatch(
                        seal["time"], dur, tenant=seal["tenant"]
                    )
                    seal["enc_done"] = max(seal["enc_done"], end)

        # ---- phase EV: XOR-delta folds + seal vertical parity ----------------
        ev_ops: list[DecodeOp] = []
        ev_owner: list[tuple] = []
        ev_ready: list[float] = []
        ev_tenant: list[str] = []
        ev_tid: list[int] = []
        if has_parity:
            par_state: dict = {}
            folds: dict = {}
            for ji, job in enumerate(jobs):
                gid = job["gid"]
                cols = []
                for c in range(n):
                    par_key = (gid, parity_row, c)
                    ok = par_state.get(par_key)
                    if ok is None:
                        # a lost parity column is reconciled later by
                        # repair instead
                        ok = self.store.available(par_key)
                        if (
                            ok
                            and cfg.verify_checksums
                            and not self.store.verify(par_key)
                        ):
                            self._note_corrupt(
                                par_key,
                                job["req"].time,
                                report,
                                source="write",
                            )
                            ok = False
                        par_state[par_key] = ok
                    if not ok:
                        continue
                    ent = folds.get(par_key)
                    if ent is None:
                        tok = ("p",) + par_key
                        pool[tok] = self.store.blocks[par_key]
                        ent = folds[par_key] = {
                            "sources": [tok],
                            "jobs": [],
                            "ready": 0.0,
                        }
                    otok = ("o", ji, c)
                    ntok = ("n", ji, c)
                    pool[otok] = job["old_row"][c]
                    pool[ntok] = job["new_row"][c]
                    ent["sources"] += [otok, ntok]
                    if ji not in ent["jobs"]:
                        ent["jobs"].append(ji)
                    ent["ready"] = max(ent["ready"], job["enc_done"])
                    cols.append(c)
                job["par_cols"] = cols
            for par_key, ent in folds.items():
                gidp, prow, c = par_key
                ev_ops.append(
                    DecodeOp(
                        "EV", gidp, prow, (c,), tuple(ent["sources"]), None
                    )
                )
                ev_owner.append(("fold", par_key, tuple(ent["jobs"])))
                ev_ready.append(ent["ready"])
                j0 = ent["jobs"][0]
                ev_tenant.append(jobs[j0]["req"].tenant)
                ev_tid.append(jobs[j0]["tid"])
            for si, seal in enumerate(seals):
                mat = seal["matrix"]
                for c in range(n):
                    srcs = []
                    for r in range(len(seal["rows"])):
                        tok = ("v", si, r, c)
                        pool[tok] = mat[r, c]
                        srcs.append(tok)
                    ev_ops.append(
                        DecodeOp(
                            "EV",
                            seal["gid"],
                            parity_row,
                            (c,),
                            tuple(srcs),
                            None,
                        )
                    )
                    ev_owner.append(("seal", si, c))
                    ev_ready.append(seal["enc_done"])
                    ev_tenant.append(seal["tenant"])
                    ev_tid.append(seal["tid"])
        ev_results, ev_units = self.coalescer.execute_encode(
            ev_ops, pool.__getitem__
        )
        ev_done = self._dispatch_encode_units(
            ev_units, ev_ready, ev_tenant, ev_tid, model_cost
        )
        par_final: dict = {}
        for oi, owner in enumerate(ev_owner):
            val = ev_results[oi][ev_ops[oi].targets[0]]
            if owner[0] == "fold":
                par_final[owner[1]] = val
                for ji in owner[2]:
                    jobs[ji]["enc_done"] = max(
                        jobs[ji]["enc_done"], ev_done[oi]
                    )
            else:
                _o, si, c = owner
                seals[si]["matrix"][parity_row, c] = val
                seals[si]["enc_done"] = max(
                    seals[si]["enc_done"], ev_done[oi]
                )

        # ---- commit: store writes, client transfers, housekeeping ------------
        for par_key, val in par_final.items():
            # each parity block is written ONCE with the window's fully
            # folded value (the write re-digests it over its new bytes)
            self.store.put_block(par_key, val)
            self._corrupted_at.pop(par_key, None)
            # fresh parity bytes: stale cached copies die EVERYWHERE, and
            # only a parity block actually WRITTEN sheds its known-down
            # tombstone; an unavailable one stays negative until repair
            # or recovery brings it back
            self.meta.invalidate(par_key)
            self.meta.purge_negative([par_key])
        for job in jobs:
            self._commit_overwrite(job, report)
        for seal in seals:
            self._commit_seal(seal, report)

    def _commit_overwrite(self, job: dict, report: GatewayReport) -> None:
        """Write one full-row overwrite's blocks and bill its client
        transfers — starting at max(arrival, encode completion): the
        fabric carries ENCODED bytes, which cannot exist before the
        billed encode launches land."""
        req = job["req"]
        gid, row, oid = job["gid"], job["row"], job["oid"]
        q = self._block_bytes
        new_row = job["new_row"]
        parity_row = self.family.rows - 1
        client = self._client_port(req)
        tid = job["tid"]
        tracer = self.tracer
        xfer_at = max(req.time, job["enc_done"])
        inflight = self._put_inflight.setdefault(req.tenant, [])
        done = xfer_at
        nbytes = 0
        par_cols = set(job.get("par_cols") or ())
        for c in range(self.code.n):
            old_key = (gid, row, c)
            par_key = (gid, parity_row, c)
            if c in par_cols:
                end = self.sim.transfer(
                    Transfer(
                        client,
                        self.store.node_of(par_key),
                        int(q),
                        xfer_at,
                        tenant=self._fab_tenant(req.tenant),
                        ctx=(tid, tid) if tracer.enabled else None,
                    )
                )
                inflight.append((end, float(q)))
                done = max(done, end)
                nbytes += q
            self.store.put_block(old_key, new_row[c])
            # a full overwrite wipes any undetected silent damage
            self._corrupted_at.pop(old_key, None)
            end = self.sim.transfer(
                Transfer(
                    client,
                    self.store.node_of(old_key),
                    int(q),
                    xfer_at,
                    tenant=self._fab_tenant(req.tenant),
                    ctx=(tid, tid) if tracer.enabled else None,
                )
            )
            inflight.append((end, float(q)))
            done = max(done, end)
            nbytes += q
            # PUT invalidations propagate to EVERY shard's cache: a
            # routed overwrite must not leave pre-write bytes servable
            # from a sibling shard that cached them for a vertical read
            self.meta.invalidate(old_key)
            self.meta.invalidate(par_key)
            # the data write re-placed its block on an alive node:
            # that tombstone is stale (the parity one is handled at
            # the fold commit, only when actually written)
            self.meta.purge_negative([old_key])
            # a client write supersedes any in-flight repair write-back
            self._healing.pop(old_key, None)
            self._healing.pop(par_key, None)
            self._reprice_on_heal.discard(old_key)
            self._reprice_on_heal.discard(par_key)
            self._lost_at.pop(old_key, None)
            if self.store.available(par_key):
                self._lost_at.pop(par_key, None)
        self._expected[oid] = job["new_data"]
        self._deleted.discard(oid)  # an overwrite resurrects a tombstone
        if tracer.enabled:
            tracer.root_span(
                "request",
                req.time,
                done,
                tid,
                track=("tenant", req.tenant),
                object_id=oid,
                kind="put",
                tenant=req.tenant,
                degraded=False,
                bytes=nbytes,
                cache_hits=0,
                fetch_at=xfer_at,
            )
            tracer.end_trace(tid, latency=done - req.time)
        report.add_record(
            RequestRecord(
                req.time, oid, "put", done - req.time, False, nbytes, 0, 0,
                tenant=req.tenant,
            )
        )

    def _commit_seal(self, seal: dict, report: GatewayReport) -> None:
        """Place one sealed group (rows x n blocks) and register its
        rows as synthetic objects above SEAL_OID_BASE, so sealed small
        objects serve/plan/repair like any other group row."""
        gid = seal["gid"]
        mat = seal["matrix"]
        q = self._block_bytes
        if self.config.verify:
            objs = np.stack([rd for (_sq, rd, _x) in seal["rows"]])
            want = self.family.encode_group(objs).cpu().numpy()
            if not np.array_equal(mat, want):
                raise AssertionError(
                    f"sealed-stripe encode mismatch for group {gid}"
                )
        self.store.put_group(gid, mat)
        client = -(
            1
            + (self.shard_id or 0) * self.config.num_client_ports
            + zlib.crc32(gid.encode()) % self.config.num_client_ports
        )
        xfer_at = max(seal["time"], seal["enc_done"])
        inflight = self._put_inflight.setdefault(seal["tenant"], [])
        tid = seal["tid"]
        tracer = self.tracer
        done = xfer_at
        nbytes = 0
        for r in range(mat.shape[0]):
            for c in range(self.code.n):
                end = self.sim.transfer(
                    Transfer(
                        client,
                        self.store.node_of((gid, r, c)),
                        int(q),
                        xfer_at,
                        tenant=self._fab_tenant(seal["tenant"]),
                        ctx=(tid, tid) if tracer.enabled else None,
                    )
                )
                inflight.append((end, float(q)))
                done = max(done, end)
                nbytes += q
        members = []
        for r, (seq, row_data, exts) in enumerate(seal["rows"]):
            oid = self._seal_oid_base + seq
            self._objects[oid] = (gid, r)
            self._expected[oid] = row_data
            self._sealed_rows[seq] = oid
            self._sealed_extents.extend(exts)
            members.append(oid)
        self._groups[gid] = members
        report.metrics.counter("stripes_sealed").inc()
        report.metrics.counter("seal_bytes").inc(nbytes)
        if tracer.enabled:
            tracer.root_span(
                "request",
                seal["time"],
                done,
                tid,
                track=("tenant", seal["tenant"]),
                object_id=-1,
                kind="seal",
                tenant=seal["tenant"],
                degraded=False,
                bytes=nbytes,
                cache_hits=0,
                fetch_at=xfer_at,
            )
            tracer.end_trace(tid, latency=done - seal["time"])

    def seal_flush(
        self, at: float, report: GatewayReport | None = None
    ) -> int:
        """Drain the small-object packer: seal the partial open row
        (zero-padded tail), pad out the last group with zero filler rows
        (zero bytes are identity under both codes — mirrors
        load_objects' padding), and encode/place what remains. Returns
        the number of groups sealed."""
        if self._sealer is None:
            return 0
        report = report if report is not None else GatewayReport()
        self._pending_rows.extend(self._sealer.flush())
        t = self.family.objects_per_group
        if self._pending_rows:
            while len(self._pending_rows) % t:
                self._pending_rows.append(self._sealer.zero_row())
        groups = []
        while self._pending_rows:
            rows = self._pending_rows[:t]
            del self._pending_rows[:t]
            gid = f"w{self._seal_tag}{self._seal_group_seq}"
            self._seal_group_seq += 1
            groups.append(
                {
                    "gid": gid,
                    "rows": rows,
                    "time": at,
                    "tenant": DEFAULT_TENANT,
                    "enc_done": at,
                }
            )
        self._encode_window([], groups, report)
        return len(groups)

    # -- cluster fault events (scenario engine) ----------------------------------
    def _apply_cluster_event(self, evt, report: GatewayReport) -> bool:
        """Apply one node-level fault event; returns True when the event
        creates missing blocks that background repair should chase.

        Gray-failure events ride the same stream: SlowNode/SlowNicEvent
        degrade the fabric model's per-node rate (no blocks lost — repair
        is not triggered), and CorruptionEvent flips bits in place. A
        silent corruption (bitflip / torn) creates NO missing block yet:
        the damage surfaces only when a digest check — fetch, scrub, or
        repair-source verify — catches it, which is exactly the
        detection-latency gap the integrity plane measures."""
        if isinstance(evt, (SlowNodeEvent, SlowNicEvent)):
            direction = getattr(evt, "direction", "both")
            self.sim.set_node_rate(evt.node, evt.rate_factor, direction=direction)
            report.metrics.counter(
                "slow_events", node=str(evt.node), direction=direction
            ).inc()
            return False
        if isinstance(evt, CorruptionEvent):
            if evt.blocks:
                keys = [tuple(k) for k in evt.blocks]
            else:
                # deterministic victim pick: crc32-keyed order over the
                # node's resident blocks (stable across runs and immune
                # to dict-insertion order)
                keys = sorted(
                    (k for k in self.store.keys_on_node(evt.node)
                     if k in self.store.blocks),
                    key=lambda k: zlib.crc32(repr(k).encode()),
                )
                if evt.count > 0:
                    keys = keys[: evt.count]
            wants_repair = False
            for key in keys:
                if not self.store.corrupt_block(key, mode=evt.mode):
                    continue
                report.metrics.counter("blocks_corrupted", mode=evt.mode).inc()
                if evt.mode == "erase":
                    # hard loss, like a test's drop_block: visible to the
                    # planner immediately, chased by repair immediately
                    self._lost_at.setdefault(key, evt.time)
                    self._healing.pop(key, None)
                    wants_repair = True
                else:
                    # SILENT: the store still serves the block; only the
                    # stale digest knows. Stamp the injection time so
                    # detection latency is measurable.
                    self._corrupted_at.setdefault(key, evt.time)
            return wants_repair
        if isinstance(evt, NodeRecoverEvent):
            keys = self.store.keys_on_node(evt.node)
            self.store.heal_node(evt.node)
            # transient failure over: the node's blocks are back, so
            # their negative entries expire NOW, not at their TTL —
            # in every shard's cache, not just the one applying the event
            self.meta.purge_negative(keys)
            for key in keys:
                if self.store.available(key):
                    t0 = self._lost_at.pop(key, None)
                    if t0 is not None:
                        report.restored_samples.append(evt.time - t0)
            # a recovery can restore the SOURCES a stuck group was
            # waiting on (its missing set changes, clearing the stuck
            # memo) — with no failure event left to queue a repair, the
            # recovery itself must trigger a re-scan when losses remain
            return bool(self._lost_at or self._repair_stuck)
        if isinstance(evt, CapacityLossEvent):
            # capture keys BEFORE the store drops their placement
            lost = self.store.lose_node_blocks(evt.node)
            for key in lost:
                self._lost_at.setdefault(key, evt.time)
                # data destroyed: any in-flight heal of this key is moot
                self._healing.pop(key, None)
                self.meta.put_negative(key, evt.time, self.config.negative_ttl)
            return bool(lost)
        # FailureEvent: transient crash — disks survive, the node may
        # recover with its blocks intact
        assert isinstance(evt, FailureEvent), f"unknown cluster event {evt!r}"
        keys = [
            k for k in self.store.keys_on_node(evt.node) if k in self.store.blocks
        ]
        self.store.fail_nodes([evt.node])
        for key in keys:
            self._lost_at.setdefault(key, evt.time)
            self.meta.put_negative(key, evt.time, self.config.negative_ttl)
        return True

    # -- background repair -------------------------------------------------------
    def _observed_p99(self, report: GatewayReport, at_time: float) -> float | None:
        """Recent foreground p99 the pacer reacts to: completed GETs of
        SLO-declaring tenants (all tenants when none declare) arriving in
        the trailing ``pacing_window``. None => idle (no recent traffic)."""
        slos = self.config.tenant_slo_p99 or {}
        since = at_time - self.config.pacing_window
        # report.recent holds the trailing completed GETs (bounded deque)
        # — the pacer's observation window no longer needs the unbounded
        # per-request record list, so streaming mode paces identically
        lats = [
            lat
            for (t, tenant, lat) in report.recent
            if since <= t <= at_time and (not slos or tenant in slos)
        ]
        if not lats:
            return None
        # same interpolating definition as GatewayReport.latency_percentile
        # — an index quantile would degenerate to the window MAX below
        # 100 samples and let one outlier throttle repair
        return float(np.percentile(lats, 99))

    def _foreground_pressure(self, at_time: float) -> float:
        """The pacer's fast signal: the estimated completion time of a
        degraded GET arriving right now — worst committed foreground
        backlog on any send port plus the k + t source-block
        serialization such a read pays on its client NIC. Completed-
        request p99 lags by exactly the queueing it should prevent (a
        request hurt by repair is only OBSERVED after it finishes
        waiting); port backlog reflects full-weight repair reservations
        the moment they are booked, so the loop reacts before the
        damage reaches the latency records. Zero while no port is
        backlogged: an idle fabric is no reason to slow repair.

        The backlog is read per SLO-declaring tenant (their fair-share
        cursors differ when they ride at different fabric weights);
        without declared SLOs it falls back to the default foreground
        tenant."""
        slos = self.config.tenant_slo_p99 or {}
        tenants = tuple(slos) or (FOREGROUND_TENANT,)
        backlog = max(
            (
                self.sim.send_backlog(node, self._fab_tenant(tenant), at_time)
                for node in self.store.alive_nodes()
                for tenant in tenants
            ),
            default=0.0,
        )
        if backlog <= 0.0:
            return 0.0
        serialization = (
            self.family.degraded_fetch_blocks
            * self._block_bytes
            / self.profile.node_bandwidth
        )
        return backlog + serialization

    def _background_repair(self, at_time: float, report: GatewayReport) -> bool:
        """Repair up to ``repair_groups_per_run`` groups; returns True
        when pending groups remain (the caller requeues a continuation).
        Groups whose missing set provably cannot shrink (fix_group ran
        and left it unchanged) are skipped until their failure set
        changes — a continuation loop must not spin on data loss."""
        self.fixer.not_before = at_time
        pending: list[tuple[str, list[BlockKey]]] = []
        for gid in self._groups:
            if not self.meta.owns_group(self.shard_id, gid):
                # under sharding each group's repair runs on exactly one
                # shard (directory-hashed), so N shards split the
                # backlog; a dead shard's groups re-hash to survivors
                continue
            missing = [
                (gid, r, c)
                for r in range(self.family.rows)
                for c in range(self.code.n)
                if not self.store.available((gid, r, c))
            ]
            if not missing:
                self._repair_stuck.pop(gid, None)
                continue
            if self.config.verify_checksums:
                # the rebuild reads this group's surviving blocks as
                # decode sources — verify them first so a silently-
                # corrupt source joins the missing set instead of
                # poisoning the regenerated blocks (which would carry a
                # fresh digest over wrong bytes)
                held = [
                    (gid, r, c)
                    for r in range(self.family.rows)
                    for c in range(self.code.n)
                    if (gid, r, c) in self.store.blocks
                ]
                nbytes = sum(self.store.blocks[key].nbytes for key in held)
                with host.span("repair.verify", nbytes, group=gid):
                    bad = self.store.verify_many(held)
                for key in bad:
                    self._note_corrupt(
                        key, at_time, report, source="repair",
                        queue_repair=False,
                    )
                    missing.append(key)
            if self._repair_stuck.get(gid) == frozenset(missing):
                continue
            pending.append((gid, missing))
        budget = self.config.repair_groups_per_run
        if budget is None:
            budget = len(pending)
        tracer = self.tracer
        rtid = 0
        run_end = at_time
        healed = 0
        if tracer.enabled and pending:
            rtid = tracer.begin_trace()
            self.fixer.trace_ctx = (rtid, rtid)
        for gid, missing in pending[:budget]:
            if self._pacer is not None:
                # closed loop: re-evaluate per group, so within one long
                # repair the share tracks mounting MTTR urgency (the
                # repair tenant's own makespan is "how long this repair
                # has been dragging")
                elapsed_anchor = max(
                    at_time, self.sim.class_makespan.get(self._repair_tenant, 0.0)
                )
                oldest = min(
                    (self._lost_at.get(k, at_time) for k in missing),
                    default=at_time,
                )
                observed = self._observed_p99(report, at_time)
                pressure = self._foreground_pressure(at_time)
                if pressure > 0.0:
                    observed = max(observed or 0.0, pressure)
                share = self._pacer.share(
                    observed,
                    self._pacing_slo,
                    outstanding_for=elapsed_anchor - oldest,
                )
                # fabric pacing acts on this shard's repair LANE (other
                # shards' repairs pace independently); the engine pool
                # is private, so the base name suffices there
                self.sim.set_tenant_weight(self._repair_tenant, share)
                self._pool.set_weight(REPAIR_TENANT, share)
                report.pacing.append((round(elapsed_anchor, 6), round(share, 4)))
                if rtid:
                    tracer.instant(
                        "pacing",
                        elapsed_anchor,
                        rtid,
                        rtid,
                        track=("repair", "repair"),
                        share=round(share, 4),
                        observed_p99=observed,
                        pressure=round(pressure, 6),
                    )
            rep = self.fixer.fix_group(gid)
            report.repair_reports.append(rep)
            # repaired blocks stay invisible to reads until the repair's
            # background transfers complete on the fabric AND its decode
            # compute clears the (shared, weighted) engine pool
            done = self.sim.class_makespan.get(self._repair_tenant, at_time)
            compute = rep.compute_time
            if self.config.decode_cost is not None:
                compute = self.config.decode_cost * rep.blocks_repaired
            elif self.config.decode_cost_per_tile is not None:
                # throughput model: each repaired block is one decoded
                # row of block_bytes, priced at the coalescer tile width
                compute = (
                    self.config.decode_cost_per_tile
                    * rep.blocks_repaired
                    * self.coalescer.tiles_for(self._block_bytes)
                )
            if compute > 0.0:
                # fetch -> decode -> write-back: the decode cannot start
                # before the repair's fabric transfers deliver its inputs
                _, eng_done = self._pool.dispatch(
                    done,
                    compute,
                    tenant=REPAIR_TENANT,
                    ctx=(
                        (rtid, rtid, {"kind": "repair.decode", "group": gid})
                        if rtid
                        else None
                    ),
                )
                done = max(done, eng_done)
            run_end = max(run_end, done)
            still_missing = []
            for key in missing:
                if self.store.available(key):
                    self._healing[key] = done
                    # the block is no longer known-down; the _healing
                    # gate (not the tombstone) hides it until its
                    # write-back transfers land — purged cluster-wide
                    self.meta.purge_negative([key])
                    t0 = self._lost_at.pop(key, None)
                    if t0 is not None:
                        report.mttr_samples.append(done - t0)
                        healed += 1
                        if rtid:
                            tracer.instant(
                                "repair.heal",
                                done,
                                rtid,
                                rtid,
                                track=("repair", "repair"),
                                key=str(key),
                                mttr=round(done - t0, 6),
                            )
                else:
                    still_missing.append(key)
            if still_missing:
                # fix_group repaired everything it could: what's left is
                # stuck until the failure set changes (data loss, or a
                # recovery event restoring sources)
                self._repair_stuck[gid] = frozenset(still_missing)
            else:
                self._repair_stuck.pop(gid, None)
        if rtid:
            tracer.root_span(
                "repair.run",
                at_time,
                max(run_end, at_time),
                rtid,
                track=("repair", "repair"),
                groups=min(budget, len(pending)),
                healed=healed,
            )
            tracer.end_trace(rtid)
            self.fixer.trace_ctx = None
        return len(pending) > budget

    # -- durability audit ---------------------------------------------------------
    def audit_durability(self) -> dict:
        """Ground-truth durability snapshot against the RAW store (cache
        copies don't count — a reconstruction in gateway memory is not a
        durable replica): blocks currently missing, blocks in clusters
        the code provably cannot rebuild (``blocks_lost`` — data loss),
        and objects no read plan can serve right now."""
        missing_blocks = 0
        blocks_lost = 0
        for gid in self._groups:
            fm = self.store.failure_matrix(gid, self.family.rows, self.code.n)
            missing_blocks += int(fm.sum())
            if self.family.name == "core":
                for cluster in independent_clusters(fm):
                    if not is_recoverable(self.code, cluster):
                        blocks_lost += int(cluster.sum())
            elif not self.family.group_recoverable(
                lambda rc, g=gid: self.store.available((g, rc[0], rc[1]))
            ):
                missing_blocks_in_group = int(fm.sum())
                blocks_lost += missing_blocks_in_group
        store_planner = DegradedReadPlanner(
            self.store, self.code, family=self.family
        )
        unreadable = 0
        for oid, (gid, row) in self._objects.items():
            try:
                store_planner.plan(gid, row)
            except UnreadableObjectError:
                unreadable += 1
        return {
            "missing_blocks": missing_blocks,
            "blocks_lost": blocks_lost,
            "unreadable_objects": unreadable,
        }

    # -- write consistency audits -------------------------------------------------
    def audit_parity(self) -> dict:
        """Ground-truth parity freshness audit: re-encode every group
        from the gateway's expected object contents and compare each
        RESIDENT stored block byte-for-byte. A block whose stored digest
        fails (silent corruption awaiting detection) counts as
        ``corrupt``, NOT ``stale`` — staleness means the write path
        forgot a delta; corruption is a modeled fault the integrity
        plane will catch and repair. Zero ``stale`` after any churn
        trace is the write dataplane's consistency contract."""
        checked = stale = corrupt = 0
        t = self.family.objects_per_group
        k, q = self.code.k, self._block_bytes
        for gid, members in self._groups.items():
            objs = np.zeros((t, k, q), dtype=np.uint8)
            for oid in members:
                _g, r = self._objects[oid]
                objs[r] = self._expected[oid]
            want = self.family.encode_group(objs).cpu().numpy()
            for r in range(self.family.rows):
                for c in range(self.code.n):
                    key = (gid, r, c)
                    blk = self.store.blocks.get(key)
                    if blk is None:
                        continue
                    checked += 1
                    if not self.store.verify(key):
                        corrupt += 1
                    elif not np.array_equal(blk, want[r, c]):
                        stale += 1
        return {
            "blocks_checked": checked,
            "stale_blocks": stale,
            "corrupt_blocks": corrupt,
        }

    def audit_sealed_stripes(self) -> dict:
        """End-to-end sealed-extent audit through DEGRADED paths: plan
        every sealed row against the RAW store (cache copies don't
        count), host-execute the plan's reconstructions, and compare
        each extent's bytes against the sha256 recorded at append time.
        Run after a fault trace: zero ``extents_wrong`` means every
        sealed byte decodes identically through whatever degraded path
        the failure set forces."""
        planner = DegradedReadPlanner(self.store, self.code, family=self.family)
        rows_checked = rows_unreadable = rows_degraded = 0
        extents = wrong = 0
        rows_of: dict[int, list[Extent]] = {}
        for ext in self._sealed_extents:
            rows_of.setdefault(ext.row_seq, []).append(ext)
        for seq, exts in sorted(rows_of.items()):
            oid = self._sealed_rows.get(seq)
            if oid is None:
                continue  # row sealed but its group not yet placed
            gid, row = self._objects[oid]
            rows_checked += 1
            try:
                plan = planner.plan(gid, row)
            except UnreadableObjectError:
                rows_unreadable += 1
                continue
            if plan.degraded:
                rows_degraded += 1
            decoded: dict[int, np.ndarray] = {}
            for op in plan.decodes:
                decoded.update(self._host_decode(op))
            flat = np.concatenate(
                [
                    np.asarray(
                        decoded[c]
                        if c in decoded
                        else self.store.blocks[(gid, row, c)]
                    ).ravel()
                    for c in range(self.code.k)
                ]
            )
            for ext in exts:
                extents += 1
                chunk = flat[ext.offset : ext.offset + ext.length]
                if hashlib.sha256(chunk.tobytes()).hexdigest() != ext.digest:
                    wrong += 1
        return {
            "rows_checked": rows_checked,
            "rows_unreadable": rows_unreadable,
            "rows_degraded": rows_degraded,
            "extents_checked": extents,
            "extents_wrong": wrong,
            "extents_pending": (
                self._sealer.pending_extents if self._sealer else 0
            ),
        }

    def _host_decode(self, op: DecodeOp) -> dict[int, np.ndarray]:
        """Execute one reconstruction host-side (audit path only — zero
        simulated cost, raw store sources)."""
        srcs = np.stack([self.store.blocks[s] for s in op.sources])
        if op.coeffs is None:
            out = srcs[0].copy()
            for s in srcs[1:]:
                np.bitwise_xor(out, s, out=out)
            return {op.targets[0]: out}
        out = np_matmul(np.asarray(op.coeffs, dtype=np.uint8), srcs)
        return {col: out[i] for i, col in enumerate(op.targets)}

    # -- SLO admission estimator -------------------------------------------------
    def _decode_launch_estimate(self) -> float:
        """Expected scaled wall time of one batched decode launch, from
        the coalescer's measured history (0 until the first launch —
        optimistic, so cold-start traffic is admitted). Modeled-cost mode
        returns the modeled cost exactly; per-tile mode prices the
        rolling billed tiles-per-launch average."""
        if self.config.decode_cost is not None:
            return self.config.decode_cost
        if self.config.decode_cost_per_tile is not None:
            if not self._pt_launches:
                return 0.0
            return (
                self.config.decode_cost_per_tile
                * self._pt_tiles
                / self._pt_launches
            )
        st = self.coalescer.stats
        return st.compute_time / st.decode_calls if st.decode_calls else 0.0

    def _encode_launch_estimate(self) -> float:
        """Expected scaled wall time of one encode launch: the modeled
        cost when set (``encode_cost``, falling back to ``decode_cost``),
        else the coalescer's measured encode history, else the decode
        estimate (optimistic cold start — admit early traffic)."""
        cfg = self.config
        if cfg.encode_cost is not None:
            return cfg.encode_cost
        if cfg.decode_cost is not None:
            return cfg.decode_cost
        st = self.coalescer.stats
        if st.encode_calls:
            return st.encode_compute_time / st.encode_calls
        return self._decode_launch_estimate()

    def _estimate_put_time(self, req: Request, now: float) -> float:
        """Admission estimate for a PUT arriving ``now``: the tenant's
        own in-flight write bytes + this PUT's write bytes serializing
        at the tenant's guaranteed fair-share rate, plus (full
        overwrites) the encode-engine wait and the window's two encode
        launches (EH + EV). O(1) on purpose, like
        ``_estimate_service_time`` — admission may not re-run the
        simulation."""
        tenant = req.tenant
        pending = self._put_inflight.get(tenant)
        live: list[tuple[float, float]] = []
        if pending:
            live = [e for e in pending if e[0] > now]
            self._put_inflight[tenant] = live
        rate = self.sim.weight_of(tenant) * self.profile.node_bandwidth
        if req.nbytes is not None:
            write_bytes = float(req.nbytes)
        else:
            per_col = 2 if self.family.rows > 1 else 1
            write_bytes = float(self.code.n * per_col * self._block_bytes)
        est = (sum(b for _e, b in live) + write_bytes) / rate
        if req.nbytes is None:
            est += max(0.0, self._pool.earliest_start(now) - now)
            est += 2 * self._encode_launch_estimate()
        return est

    def _estimate_service_time(
        self, plan: ReadPlan, now: float, tenant: str
    ) -> float:
        """Estimated completion time for a GET arriving ``now``: source
        blocks not in cache serialize into the request's single client
        NIC at the tenant's GUARANTEED fair-share rate, behind the
        tenant's own most-backlogged source-port cursor (reservations of
        lighter tenants are preemptible under the quantum fabric, so
        they don't count against it), and a degraded plan then waits for
        the least-loaded decode engine's backlog plus its own launches.
        O(plan) on purpose — an admission decision may not re-run the
        simulation — so it uses the simulator's per-(port, tenant)
        cursors rather than exact timeline search."""
        fetch_bytes = 0
        net_backlog = 0.0
        for key in plan.source_keys:
            if self.cache is not None and key in self.cache:
                continue
            fetch_bytes += self._block_bytes
            net_backlog = max(
                net_backlog,
                self.sim.send_backlog(
                    self.store.node_of(key), self._fab_tenant(tenant), now
                ),
            )
        share = self.sim.weight_of(tenant)
        est = net_backlog + fetch_bytes / (share * self.profile.node_bandwidth)
        # write pressure: the tenant's in-flight PUT bytes share the same
        # fair-share pipe its fetches ride — reads queue behind committed
        # writes, so admission must charge them (no puts => term is 0 and
        # read-only traces price identically to the pre-write estimator)
        pending = self._put_inflight.get(tenant)
        if pending:
            live = [e for e in pending if e[0] > now]
            self._put_inflight[tenant] = live
            est += sum(b for _e, b in live) / (
                share * self.profile.node_bandwidth
            )
        if self.config.pipeline == SERIAL:
            # serial mode gates every fetch on the previous window's
            # completion — under load that barrier IS the latency
            est += max(0.0, self._window_free - now)
        if plan.decodes:
            est += max(0.0, self._pool.earliest_start(now) - now)
            est += self._decode_launch_estimate() * len(plan.decodes)
        return est

    # -- helpers ----------------------------------------------------------------
    def _client_port(self, req: Request) -> int:
        # negative node ids: client NICs outside the storage cluster.
        # Hashed per REQUEST, not per object: a popular object is popular
        # because many distinct clients want it, so its traffic spreads
        # over client NICs instead of melting one artificial hot port.
        h = (req.object_id * 1_000_003 + int(req.time * 1e7)) % (2**31)
        # each shard gets a private client-NIC stripe: shard 1's port -33
        # is not shard 0's port -1, so shards don't serialize on fake
        # shared client hardware (the whole point of scale-out)
        base = (self.shard_id or 0) * self.config.num_client_ports
        return -(1 + base + h % self.config.num_client_ports)

    def _assemble_payload(self, req, plan, fetched, decoded) -> np.ndarray:
        """The GET's (k, q) payload: direct blocks + reconstructions."""
        gid, row = self._objects[req.object_id]
        got = []
        for c in range(self.code.k):
            key = (gid, row, c)
            if key in fetched and c not in decoded:
                got.append(fetched[key])
            else:
                got.append(decoded[c])
        return np.stack(got)

    def _verify_get(self, req, payload: np.ndarray) -> None:
        want = self._expected[req.object_id]
        if not np.array_equal(payload, want):
            raise AssertionError(
                f"GET integrity failure for object {req.object_id}"
            )
