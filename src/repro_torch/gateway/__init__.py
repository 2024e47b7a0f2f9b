# Client-facing object-storage serving layer over the simulated CORE
# cluster: Zipf/Poisson workloads, per-request degraded-read planning
# (paper Table 1), a pipelined fetch->decode->verify dataplane whose
# decode stage is the ragged tile dataplane (GatewayConfig.coalesce,
# default "ragged"): a window's whole mixed-shape decode set — H and V
# ops of any (M, K, blocklen) — is staged as fixed-width descriptor
# tiles and decoded in chunked CUDA tile-kernel launches per kind, with
# <= 2 launch signatures per kind and only tail-tile padding; the
# measured launch time is split by tile ranges into per-op LaunchUnits
# so the engine pool spreads one launch across engines. coalesce="bucketed"
# keeps the per-shape stacked launches (ladder-padded, autotuned) as the
# measured baseline. Plus rebuild-cost-aware block caching and
# weighted-fair quantum fabric sharing between any number of tenants.
#
# Tenancy and SLOs: every request is tagged with a tenant; each tenant's
# fabric traffic is shaped by its weighted-fair quantum ratio
# (GatewayConfig.tenant_weights — background repair is just the "repair"
# tenant, whose weight defaults to background_share), and tenants may
# declare a p99 latency target (tenant_slo_p99). The admission
# controller estimates each arriving GET's completion time from the
# client-NIC fetch serialization, the decode-engine backlog, and the
# measured per-launch decode cost; requests that would bust their
# tenant's SLO are rejected up front (admission="reject") or first
# degraded to the latency-cheapest viable plan (admission="degrade").
# Decode runs on num_engines parallel simulated engine timelines with
# least-loaded dispatch under per-tenant engine shares (EnginePool:
# full-weight tenants dispatch tenant-blind; a share-w tenant is
# rate-capped at w of the pool's throughput), so decode-bound degraded
# workloads scale with the engine pool while throttled tenants cannot
# crowd it. Per-tenant latency, rejection, starvation, and
# deadline-miss accounting surface in GatewayReport and NetSimulator.
#
# Fault scenarios + closed-loop repair (see repro_torch.scenario for the
# trace DSL): serve() consumes node-level cluster events mid-run —
# FailureEvent (transient crash), NodeRecoverEvent (blocks return
# intact; negative cache entries purged), CapacityLossEvent (blocks
# destroyed; only repair restores them). Blocks on down nodes are
# negative-cached with a TTL (GatewayConfig.negative_ttl) so planning
# skips re-probing known failures; MTTR is sampled per healed block
# (GatewayReport.mttr_samples / restored_samples) and
# audit_durability() reports provable data loss. Gray failures ride the
# same event stream: CorruptionEvent flips bits in place (silent until a
# digest check catches it), SlowNode/SlowNicEvent degrade a node's
# effective link rate. The integrity plane (verify_checksums, default
# on) checks every store fetch and decode output against the crc32
# digest recorded at PUT, reclassifies mismatches as erasures (replan ->
# CORE parity first, RS fallback; corrupt replica quarantined,
# tombstoned, queued for repair), and a paced background scrubber
# (scrub_interval) bounds detection latency for data no read touches.
# hedge=True races direct fetches stuck past a healthy-fabric deadline
# against the cheapest alternate reconstruction, under a per-tenant
# speculative-byte budget (hedge_budget). repair_pacing=True
# closes the SLO loop: a PacingController (storage/repair.py) maps
# observed foreground p99 headroom against tenant_slo_p99 — plus MTTR
# urgency as a repair drags — to the "repair" tenant's fabric weight
# and engine share before every group repair (GatewayReport.pacing).
#
# Write dataplane (GatewayConfig.write_coalesce, default "ragged"):
# PUT windows mirror the decode megakernel — a batch's RS parity-row
# generations (kind "EH") and XOR-delta vertical-parity folds (kind
# "EV", one fold op per touched parity block via XOR associativity)
# each run as ONE ragged ENCODE launch (kernels/ragged_encode.py),
# billed on the same engine pool decodes ride; client transfers start
# only after the billed encodes land. write_coalesce="sync" is the
# per-PUT launch baseline. Small PUTs (Request.nbytes set) journal for
# an instant ack and pack into shared codeword rows via StripeSealer;
# deletes tombstone in place. audit_parity() / audit_sealed_stripes()
# are the end-to-end churn consistency audits (zero stale parity, every
# sealed extent byte-identical through degraded decode).
#
# Multi-gateway scale-out (metadata.py + sharding.py): the namespace
# metadata plane (stripe maps, object->shard consistent-hash directory,
# ground truth, tombstones, fault bookkeeping, cache-coherence fan-out)
# is split from the per-shard data path, so N ObjectGateway shards run
# over ONE shared BlockStore/NetSimulator. ShardedGateway is the front
# door: requests route by crc32 consistent hash (vnodes per shard),
# each shard keeps its own cache/engine pool/admission/repair fixer
# (fabric lanes tagged "tenant@s<id>", weights inherited from the base
# tenant), cluster events apply once with repair ownership split by
# group hash, and ShardFailEvent kills a shard mid-run — storage is
# untouched, so its namespace ranges fail over to survivors with zero
# lost blocks. serve() returns GatewayReport.merged across shards.
from repro_torch.gateway.cache import CacheStats, LRUBlockCache
from repro_torch.gateway.coalescer import (
    PAD_LADDER,
    CoalescerStats,
    DecodeCoalescer,
    LaunchUnit,
)
from repro_torch.gateway.gateway import (
    EnginePool,
    GatewayConfig,
    GatewayReport,
    ObjectGateway,
    RequestRecord,
)
from repro_torch.gateway.planner import (
    DecodeOp,
    DegradedReadPlanner,
    ReadPlan,
    UnreadableObjectError,
)
from repro_torch.gateway.metadata import MetadataPlane, ShardDirectory
from repro_torch.gateway.sealer import Extent, StripeSealer
from repro_torch.gateway.sharding import ShardedGateway
from repro_torch.gateway.workload import (
    CapacityLossEvent,
    CorruptionEvent,
    DEFAULT_TENANT,
    FailureEvent,
    NodeRecoverEvent,
    Request,
    ShardFailEvent,
    SlowNicEvent,
    SlowNodeEvent,
    TenantProfile,
    WorkloadConfig,
    generate_requests,
    generate_tenant_requests,
    plan_failures,
    tenant_slo_map,
    tenant_weight_map,
    zipf_probs,
)

__all__ = [
    "DEFAULT_TENANT",
    "TenantProfile",
    "generate_tenant_requests",
    "tenant_slo_map",
    "tenant_weight_map",
    "CacheStats",
    "CapacityLossEvent",
    "CorruptionEvent",
    "SlowNicEvent",
    "SlowNodeEvent",
    "EnginePool",
    "LRUBlockCache",
    "NodeRecoverEvent",
    "PAD_LADDER",
    "CoalescerStats",
    "DecodeCoalescer",
    "LaunchUnit",
    "GatewayConfig",
    "GatewayReport",
    "MetadataPlane",
    "ObjectGateway",
    "RequestRecord",
    "ShardDirectory",
    "ShardFailEvent",
    "ShardedGateway",
    "DecodeOp",
    "DegradedReadPlanner",
    "Extent",
    "ReadPlan",
    "StripeSealer",
    "UnreadableObjectError",
    "FailureEvent",
    "Request",
    "WorkloadConfig",
    "generate_requests",
    "plan_failures",
    "zipf_probs",
]
