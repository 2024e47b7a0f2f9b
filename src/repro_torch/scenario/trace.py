"""Fault-injection scenario traces: the event DSL and seeded generators.

A ``ScenarioTrace`` is a time-sorted sequence of cluster fault events —
node crash/recover pairs (transient failures: reboots, partitions),
capacity losses (disk death: blocks destroyed, only repair brings them
back), load surges (arrival-rate multipliers the workload generator
honours), and GRAY failures — ``CorruptionEvent`` (silent bit flips /
torn writes: nothing fails until a checksum verify catches the bytes)
and ``SlowNodeEvent`` / ``SlowNicEvent`` (fail-slow rate-factor
degradation honoured by the fabric ports) — over a cluster whose nodes
are grouped into racks (failure domains). Rack-level events, flapping
nodes and flapping-slow nodes are *builders* that expand into the same
node-level vocabulary (``repro_torch.gateway.workload`` event types), and
every trace is replayable verbatim: same trace + same workload seed =>
same simulated run.

``generate_scenario`` draws a random trace from a seeded
``ScenarioConfig``: Poisson background crashes with exponential
downtimes, correlated rack bursts, flapping nodes, and a configurable
transient/permanent split — with a hard admission bound
(``max_concurrent_failures``) so generated traces never exceed the
code's tolerance: with anti-colocated placement, f concurrently-affected
nodes cost any stripe at most f blocks, so f <= n - k keeps every object
readable and every repair recoverable. Events that would breach the
bound are dropped in a deterministic admission pass (rack bursts are
trimmed, keeping the correlation as large as the bound allows).

Traces serialize to plain JSON (``to_jsonable`` / ``trace_from_jsonable``)
so a failing seed can be committed as a regression fixture.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np

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
    WorkloadConfig,
    zipf_probs,
)

ClusterEvent = (
    FailureEvent
    | NodeRecoverEvent
    | CapacityLossEvent
    | CorruptionEvent
    | SlowNodeEvent
    | SlowNicEvent
    | ShardFailEvent
)

_EVENT_TYPES = {
    "crash": FailureEvent,
    "recover": NodeRecoverEvent,
    "capacity_loss": CapacityLossEvent,
    "corrupt": CorruptionEvent,
    "slow_node": SlowNodeEvent,
    "slow_nic": SlowNicEvent,
    "shard_fail": ShardFailEvent,
}
_EVENT_NAMES = {v: k for k, v in _EVENT_TYPES.items()}


def _event_to_jsonable(e: ClusterEvent) -> dict:
    d: dict = {"kind": _EVENT_NAMES[type(e)], "time": e.time, "node": e.node}
    if isinstance(e, CorruptionEvent):
        d["blocks"] = [list(k) for k in e.blocks]
        d["mode"] = e.mode
        d["count"] = e.count
    elif isinstance(e, (SlowNodeEvent, SlowNicEvent)):
        d["rate_factor"] = e.rate_factor
        if isinstance(e, SlowNicEvent):
            d["direction"] = e.direction
    elif isinstance(e, ShardFailEvent):
        d["shard"] = e.shard
    return d


def _event_from_jsonable(d: dict) -> ClusterEvent:
    kind, t, node = d["kind"], float(d["time"]), int(d["node"])
    if kind == "corrupt":
        return CorruptionEvent(
            time=t,
            node=node,
            blocks=tuple(
                (str(k[0]), int(k[1]), int(k[2])) for k in d.get("blocks", [])
            ),
            mode=str(d.get("mode", "bitflip")),
            count=int(d.get("count", 1)),
        )
    if kind == "slow_node":
        return SlowNodeEvent(
            time=t, node=node, rate_factor=float(d.get("rate_factor", 0.1))
        )
    if kind == "slow_nic":
        return SlowNicEvent(
            time=t,
            node=node,
            rate_factor=float(d.get("rate_factor", 0.1)),
            direction=str(d.get("direction", "send")),
        )
    if kind == "shard_fail":
        return ShardFailEvent(time=t, shard=int(d["shard"]))
    return _EVENT_TYPES[kind](time=t, node=node)


@dataclass(frozen=True)
class LoadSurge:
    """Multiply the base arrival rate by ``multiplier`` for
    [time, time + duration) — the foreground pressure that makes
    SLO-aware repair pacing bite."""

    time: float
    duration: float
    multiplier: float

    def active_at(self, t: float) -> bool:
        return self.time <= t < self.time + self.duration


@dataclass(frozen=True)
class ScenarioTrace:
    """A replayable fault schedule: node-level cluster events plus load
    surges, both time-sorted. ``rack_of(node)`` exposes the failure-
    domain map the trace was built against (contiguous racks of
    ``nodes_per_rack`` nodes)."""

    num_nodes: int
    events: tuple = ()  # ClusterEvent, time-sorted
    surges: tuple = ()  # LoadSurge, time-sorted
    nodes_per_rack: int = 8
    seed: int | None = None  # generator provenance (None: hand-built)

    def rack_of(self, node: int) -> int:
        return node // self.nodes_per_rack

    def rack_nodes(self, rack: int) -> list[int]:
        lo = rack * self.nodes_per_rack
        return [n for n in range(lo, lo + self.nodes_per_rack) if n < self.num_nodes]

    def cluster_events(self) -> list[ClusterEvent]:
        """The node-level events the gateway consumes, time-sorted."""
        return sorted(self.events, key=lambda e: e.time)

    def fault_events(self) -> list[ClusterEvent]:
        """Down/degrade events only — recoveries undo faults, they aren't
        faults, and a slow event restoring full speed (rate_factor 1.0)
        is likewise a recovery. The count durability claims should be
        quoted against."""
        return [
            e for e in self.cluster_events()
            if not isinstance(e, NodeRecoverEvent)
            and not (
                isinstance(e, (SlowNodeEvent, SlowNicEvent))
                and e.rate_factor >= 1.0
            )
        ]

    def rate_multiplier(self, t: float) -> float:
        m = 1.0
        for s in self.surges:
            if s.active_at(t):
                m *= s.multiplier
        return m

    @property
    def span(self) -> float:
        ends = [e.time for e in self.events]
        ends += [s.time + s.duration for s in self.surges]
        return max(ends, default=0.0)

    def max_concurrent_down(self) -> int:
        """Worst-case concurrently-affected node count over the trace.
        Capacity-lost nodes count as affected forever (the trace itself
        cannot know when repair heals them) — the conservative bound the
        generator's admission pass enforces."""
        affected: set[int] = set()
        lost: set[int] = set()  # capacity-lost: a reboot can't restore data
        worst = 0
        # conservative same-instant ordering: a crash and a recovery at
        # the same timestamp count as overlapping (crashes first)
        ordered = sorted(
            self.events, key=lambda e: (e.time, isinstance(e, NodeRecoverEvent))
        )
        for evt in ordered:
            if isinstance(evt, (SlowNodeEvent, SlowNicEvent, ShardFailEvent)):
                # slowness / serving-shard death: data intact on the
                # storage fabric, erasure tolerance untouched
                continue
            if isinstance(evt, NodeRecoverEvent):
                if evt.node not in lost:
                    affected.discard(evt.node)
            elif isinstance(evt, CorruptionEvent):
                # corrupt bytes are erasures once detected; like capacity
                # loss, the trace can't know when repair heals them
                lost.add(evt.node)
                affected.add(evt.node)
            else:
                if isinstance(evt, CapacityLossEvent):
                    lost.add(evt.node)
                affected.add(evt.node)
            worst = max(worst, len(affected))
        return worst

    # -- serialization (replayable fixtures) --------------------------------
    def to_jsonable(self) -> dict:
        return {
            "num_nodes": self.num_nodes,
            "nodes_per_rack": self.nodes_per_rack,
            "seed": self.seed,
            "events": [_event_to_jsonable(e) for e in self.cluster_events()],
            "surges": [
                {"time": s.time, "duration": s.duration, "multiplier": s.multiplier}
                for s in self.surges
            ],
        }


def trace_from_jsonable(obj: dict) -> ScenarioTrace:
    return ScenarioTrace(
        num_nodes=int(obj["num_nodes"]),
        nodes_per_rack=int(obj.get("nodes_per_rack", 8)),
        seed=obj.get("seed"),
        events=tuple(_event_from_jsonable(e) for e in obj.get("events", [])),
        surges=tuple(
            LoadSurge(float(s["time"]), float(s["duration"]), float(s["multiplier"]))
            for s in obj.get("surges", [])
        ),
    )


# -- trace builders (the DSL's correlated / transient idioms) ----------------


def rack_failure(
    trace: ScenarioTrace, time: float, rack: int, downtime: float | None = None
) -> ScenarioTrace:
    """Correlated failure: crash every node of ``rack`` at ``time`` (one
    switch/PDU, many disks — the XORing-Elephants failure mode), with a
    rack-wide recovery ``downtime`` seconds later when given."""
    events = list(trace.events)
    for n in trace.rack_nodes(rack):
        events.append(FailureEvent(time=time, node=n))
        if downtime is not None:
            events.append(NodeRecoverEvent(time=time + downtime, node=n))
    return replace(trace, events=tuple(sorted(events, key=lambda e: e.time)))


def flapping_node(
    trace: ScenarioTrace,
    node: int,
    start: float,
    period: float,
    count: int,
    duty: float = 0.5,
) -> ScenarioTrace:
    """Transient flapping: ``count`` crash/recover cycles of ``period``
    seconds each, down for ``duty`` of every cycle."""
    events = list(trace.events)
    for i in range(count):
        t0 = start + i * period
        events.append(FailureEvent(time=t0, node=node))
        events.append(NodeRecoverEvent(time=t0 + period * duty, node=node))
    return replace(trace, events=tuple(sorted(events, key=lambda e: e.time)))


def flapping_slow(
    trace: ScenarioTrace,
    node: int,
    start: float,
    period: float,
    count: int,
    rate_factor: float = 0.1,
    duty: float = 0.5,
) -> ScenarioTrace:
    """Flapping fail-slow (the nastiest gray mode: intermittently slow,
    never down): ``count`` slow/restore cycles of ``period`` seconds,
    degraded to ``rate_factor`` for ``duty`` of every cycle."""
    events = list(trace.events)
    for i in range(count):
        t0 = start + i * period
        events.append(SlowNodeEvent(time=t0, node=node, rate_factor=rate_factor))
        events.append(
            SlowNodeEvent(time=t0 + period * duty, node=node, rate_factor=1.0)
        )
    return replace(trace, events=tuple(sorted(events, key=lambda e: e.time)))


def load_surge(
    trace: ScenarioTrace, time: float, duration: float, multiplier: float
) -> ScenarioTrace:
    surges = sorted(
        list(trace.surges) + [LoadSurge(time, duration, multiplier)],
        key=lambda s: s.time,
    )
    return replace(trace, surges=tuple(surges))


# -- seeded random generation -------------------------------------------------


@dataclass(frozen=True)
class ScenarioConfig:
    """Knobs for ``generate_scenario``. Rates are per second of simulated
    time; all randomness derives from ``seed``."""

    duration: float
    num_nodes: int
    nodes_per_rack: int = 8
    # the hard tolerance bound: concurrently-affected nodes never exceed
    # this (pass the code's n - k for always-recoverable traces)
    max_concurrent_failures: int = 2
    crash_rate: float = 1.0  # background node crashes (1/mean interarrival)
    mean_downtime: float = 0.5  # exponential transient downtime
    transient_fraction: float = 0.75  # rest are capacity losses
    # Crash inter-arrival law. "exponential" (default) is the Poisson
    # assumption; "weibull" draws Weibull(interarrival_shape) gaps —
    # shape < 1 gives the bursty, heavy-tailed churn the warehouse-
    # cluster failure study measures (Rashmi et al., 1309.0186: most
    # failures arrive in correlated bursts, not as a memoryless
    # process) — and "trace" resamples the empirical gap samples in
    # ``interarrival_samples`` (seconds). All three laws preserve
    # ``crash_rate`` as 1/mean, so tolerance-bound admission pressure is
    # comparable across laws; only the clustering changes.
    interarrival: str = "exponential"  # "exponential" | "weibull" | "trace"
    interarrival_shape: float = 0.7  # Weibull shape (k < 1 = bursty)
    interarrival_samples: tuple = ()  # empirical gaps for "trace"
    rack_burst_times: tuple = ()  # correlated bursts at these times
    rack_downtime: float = 0.5
    flap_nodes: int = 0
    flap_period: float = 0.2
    flap_count: int = 3
    # gray failures: silent corruption + fail-slow (Poisson, per second)
    corruption_rate: float = 0.0
    corruption_blocks: int = 2  # blocks damaged per corruption event
    slow_rate: float = 0.0
    slow_factor: float = 0.1  # degraded bandwidth multiplier
    mean_slow_time: float = 0.5  # exponential slow-episode length
    surges: tuple = ()  # LoadSurge passthrough
    seed: int = 0


def _crash_gap(rng: np.random.Generator, cfg: ScenarioConfig) -> float:
    """One crash inter-arrival draw under the configured law, with mean
    1/crash_rate in every mode (the Weibull scale is mean/Γ(1 + 1/k), so
    changing the law changes burstiness, not total churn)."""
    mean = 1.0 / cfg.crash_rate
    if cfg.interarrival == "exponential":
        return float(rng.exponential(mean))
    if cfg.interarrival == "weibull":
        shape = cfg.interarrival_shape
        if shape <= 0:
            raise ValueError(f"interarrival_shape must be > 0, got {shape}")
        scale = mean / math.gamma(1.0 + 1.0 / shape)
        return float(scale * rng.weibull(shape))
    if cfg.interarrival == "trace":
        samples = np.asarray(cfg.interarrival_samples, dtype=np.float64)
        if samples.size == 0 or np.any(samples <= 0):
            raise ValueError(
                "interarrival='trace' needs positive interarrival_samples"
            )
        # resample the empirical distribution, rescaled to the configured
        # mean so crash_rate stays the single churn knob
        return float(rng.choice(samples) * (mean / samples.mean()))
    raise ValueError(
        f"unknown interarrival law {cfg.interarrival!r} "
        "(want 'exponential', 'weibull' or 'trace')"
    )


def generate_scenario(cfg: ScenarioConfig) -> ScenarioTrace:
    """Draw a random trace and run the bounded admission pass.

    Candidate events come from three independent processes — background
    Poisson crashes (transient or permanent), rack bursts at the
    configured times, and flapping nodes — then a single deterministic
    sweep admits them in time order, dropping any down-event that would
    push the concurrently-affected set past ``max_concurrent_failures``
    (a dropped crash also drops its paired recovery; rack bursts are
    trimmed to the largest correlated subset that fits)."""
    rng = np.random.default_rng(cfg.seed)
    # candidate pairs: (down_time, node, kind, recover_time | None)
    candidates: list[tuple[float, int, str, float | None]] = []

    t = 0.0
    while cfg.crash_rate > 0:
        t += _crash_gap(rng, cfg)
        if t >= cfg.duration:
            break
        node = int(rng.integers(cfg.num_nodes))
        if rng.random() < cfg.transient_fraction:
            down = float(rng.exponential(cfg.mean_downtime))
            candidates.append((t, node, "crash", t + down))
        else:
            candidates.append((t, node, "capacity_loss", None))

    t = 0.0
    while cfg.corruption_rate > 0:
        t += float(rng.exponential(1.0 / cfg.corruption_rate))
        if t >= cfg.duration:
            break
        candidates.append((t, int(rng.integers(cfg.num_nodes)), "corrupt", None))

    t = 0.0
    while cfg.slow_rate > 0:
        t += float(rng.exponential(1.0 / cfg.slow_rate))
        if t >= cfg.duration:
            break
        slow_for = float(rng.exponential(cfg.mean_slow_time))
        candidates.append((t, int(rng.integers(cfg.num_nodes)), "slow", t + slow_for))

    base = ScenarioTrace(
        num_nodes=cfg.num_nodes, nodes_per_rack=cfg.nodes_per_rack, seed=cfg.seed
    )
    num_racks = max(1, (cfg.num_nodes + cfg.nodes_per_rack - 1) // cfg.nodes_per_rack)
    for bt in cfg.rack_burst_times:
        rack = int(rng.integers(num_racks))
        for n in base.rack_nodes(rack):
            candidates.append((float(bt), n, "crash", float(bt) + cfg.rack_downtime))

    flappers = rng.choice(
        cfg.num_nodes, size=min(cfg.flap_nodes, cfg.num_nodes), replace=False
    )
    for node in flappers:
        start = float(rng.uniform(0.0, max(cfg.duration - cfg.flap_count * cfg.flap_period, 0.0)))
        for i in range(cfg.flap_count):
            t0 = start + i * cfg.flap_period
            candidates.append((t0, int(node), "crash", t0 + cfg.flap_period * 0.5))

    # admission pass: stable time order (ties broken by node then kind so
    # the pass is deterministic across runs)
    candidates.sort(key=lambda c: (c[0], c[1], c[2]))
    affected: dict[int, float] = {}  # node -> release time (inf: permanent)
    events: list[ClusterEvent] = []
    for down_t, node, kind, recover_t in candidates:
        if kind == "slow":
            # fail-slow never consumes the erasure budget: the bytes are
            # intact and every transfer still completes — admit freely
            events.append(
                SlowNodeEvent(time=down_t, node=node, rate_factor=cfg.slow_factor)
            )
            events.append(SlowNodeEvent(time=recover_t, node=node, rate_factor=1.0))
            continue
        # STRICT release: a node recovering at exactly down_t still
        # counts as overlapping, so the bound holds under any
        # same-instant event ordering downstream
        for n, rel in list(affected.items()):
            if rel < down_t:
                del affected[n]
        if node in affected:
            continue  # already down/lost — flap cycle overlapping a crash
        if len(affected) >= cfg.max_concurrent_failures:
            continue  # would exceed tolerance: drop (rack bursts trim here)
        if kind == "capacity_loss":
            events.append(CapacityLossEvent(time=down_t, node=node))
            affected[node] = float("inf")
        elif kind == "corrupt":
            # corrupt blocks are erasures once detected; like capacity
            # loss, conservatively hold the node's budget slot forever
            events.append(
                CorruptionEvent(
                    time=down_t, node=node, count=cfg.corruption_blocks
                )
            )
            affected[node] = float("inf")
        else:
            events.append(FailureEvent(time=down_t, node=node))
            events.append(NodeRecoverEvent(time=recover_t, node=node))
            affected[node] = recover_t
    events.sort(key=lambda e: (e.time, e.node))
    return replace(
        base, events=tuple(events), surges=tuple(sorted(cfg.surges, key=lambda s: s.time))
    )


# -- surge-aware workload synthesis ------------------------------------------


def scenario_requests(
    wl: WorkloadConfig,
    trace: ScenarioTrace,
    tenant: str = DEFAULT_TENANT,
) -> list[Request]:
    """Poisson/Zipf GET/PUT trace whose arrival rate follows the trace's
    load surges: rate(t) = arrival_rate x trace.rate_multiplier(t).
    Implemented by thinning a homogeneous process at the peak rate, so
    the stream is reproducible from the workload seed and adding or
    removing a surge only re-times arrivals inside its own window."""
    # The thinning envelope must dominate rate(t) everywhere. Overlapping
    # surges MULTIPLY, and the product is piecewise-constant, changing
    # only at surge boundaries — it can rise at a START (a >1 surge
    # begins) or at an END (a <1 throttle window expires), so the true
    # peak is the max over every boundary instant. active_at is
    # half-open, so evaluating AT an end instant sees the surge gone.
    boundaries = [s.time for s in trace.surges] + [
        s.time + s.duration for s in trace.surges
    ]
    peak = wl.arrival_rate * max(
        [1.0] + [trace.rate_multiplier(t) for t in boundaries]
    )
    rng = np.random.default_rng(wl.seed)
    # churn kinds (delete / small-put) ride a SEPARATE derived stream:
    # drawing them from ``rng`` would shift every draw after the first
    # candidate and re-time the whole preexisting trace
    churn_rng = np.random.default_rng((wl.seed ^ 0x5EA1C0DE) % (2**31))
    perm = rng.permutation(wl.num_objects)
    probs = zipf_probs(wl.num_objects, wl.zipf_s)
    out: list[Request] = []
    t = 0.0
    while len(out) < wl.num_requests:
        t += float(rng.exponential(1.0 / peak))
        accept = float(rng.random())  # drawn unconditionally: stream stability
        rank = int(rng.choice(wl.num_objects, p=probs))
        is_put = float(rng.random()) < wl.put_fraction
        # unconditional for the same stream-stability reason as accept
        is_delete = float(churn_rng.random()) < wl.delete_fraction
        is_small = float(churn_rng.random()) < wl.small_put_fraction
        if accept >= wl.arrival_rate * trace.rate_multiplier(t) / peak:
            continue
        kind = "delete" if is_delete else ("put" if is_put else "get")
        out.append(
            Request(
                time=t,
                object_id=int(perm[rank]),
                kind=kind,
                tenant=tenant,
                nbytes=(
                    int(wl.small_put_bytes)
                    if (kind == "put" and is_small)
                    else None
                ),
            )
        )
    return out
