# Fault-injection scenario engine: drives the serving gateway over
# simulated time with the failure regimes real clusters actually see.
#
# The trace DSL (trace.py): a ScenarioTrace is a replayable, time-sorted
# schedule of node-level cluster events — FailureEvent (transient crash:
# disks survive), NodeRecoverEvent (the node rejoins with its blocks;
# the gateway purges its negative cache entries), CapacityLossEvent
# (disk death: blocks destroyed, only repair restores them) — plus
# LoadSurge windows that multiply the workload's arrival rate. Rack
# failures (one switch, many disks — the correlated mode the
# XORing-Elephants study emphasizes) and flapping nodes are builders
# that expand into the same three node-level events, so the gateway's
# event loop stays small. Gray-failure events join them: CorruptionEvent
# (silent bit-flip / torn write / erase on one node's blocks),
# SlowNodeEvent / SlowNicEvent (fail-slow: a rate factor degrades the
# node's effective link speed until a factor-1.0 event restores it;
# flapping_slow expands a duty cycle into such pairs), and
# ShardFailEvent kills a whole serving shard mid-run (storage survives;
# the ShardedGateway front door fails the namespace range over to the
# survivors). generate_scenario draws seeded random traces
# from a ScenarioConfig with a hard admission bound: with anti-colocated
# placement, f concurrently-affected nodes cost any stripe at most f
# blocks, so traces bounded at f <= n - k never exceed the code's
# tolerance — every GET stays servable and every repair recoverable
# (corruption counts against the same bound; fail-slow events don't —
# slow is not down).
# Traces serialize to JSON so a failing seed commits as a fixture.
#
# The closed loop (engine.py + gateway/gateway.py + storage/repair.py):
# the gateway consumes trace events MID-RUN — the planner replans
# against the shifting failure set, blocks on down nodes are
# negative-cached with a TTL (purged on recover/heal), and the admission
# controller's estimates track the changing plans. Repair is paced by a
# PacingController: observed foreground p99 headroom against
# tenant_slo_p99 modulates the "repair" tenant's fabric weight AND its
# decode-engine share (slowing repair when the tier nears its SLO,
# accelerating toward the MTTR target when idle), and run_scenario
# returns MTTR / durability / p99-under-failure metrics so paced and
# fixed-weight repair compare head to head (chip_smoke.py phase 7).
# deterministic_fingerprint hashes the
# wall-clock-free outcome so golden-trace replays guard event ordering.
from repro_torch.scenario.engine import (
    SURGE_FAIL_AT,
    SURGE_END,
    ScenarioResult,
    correlated_surge_setup,
    deterministic_fingerprint,
    run_scenario,
)
from repro_torch.scenario.trace import (
    ClusterEvent,
    LoadSurge,
    ScenarioConfig,
    ScenarioTrace,
    flapping_node,
    flapping_slow,
    generate_scenario,
    load_surge,
    rack_failure,
    scenario_requests,
    trace_from_jsonable,
)

__all__ = [
    "ClusterEvent",
    "LoadSurge",
    "SURGE_END",
    "SURGE_FAIL_AT",
    "ScenarioConfig",
    "ScenarioResult",
    "ScenarioTrace",
    "correlated_surge_setup",
    "deterministic_fingerprint",
    "flapping_node",
    "flapping_slow",
    "generate_scenario",
    "load_surge",
    "rack_failure",
    "run_scenario",
    "scenario_requests",
    "trace_from_jsonable",
]
