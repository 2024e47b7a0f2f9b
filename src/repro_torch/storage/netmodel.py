"""Network cost model for the simulated distributed block store.

Mirrors the paper's §5.2 model: congestion-free fabric, per-node
bandwidth caps; delays arise when a single node sends/receives multiple
blocks. Two cluster profiles from §8 are provided:

  * network-critical     — 12 MB/s links (the university thin-client rig)
  * computation-critical — 250 MB/s links (EC2 m1.small)

Compute costs are *measured* (the codec math runs for real on this host);
network time is *simulated* from byte counts and the profile, since this
container has no real cluster fabric.

Fabric sharing comes in two modes:

  * ``fifo``    — a transfer occupies both ports contiguously from the
    moment they free up; throttled tenants simply run at their weight
    fraction of the link rate. A long repair transfer
    head-of-line-blocks any later foreground read on the same ports.
  * ``quantum`` — (default) transfers are scheduled in fixed-size
    *quanta*: each quantum transmits at full link rate, and a weight-w
    tenant's quanta are spaced so the tenant consumes only w of the
    link in steady state (weighted-fair sharing; the weight is the
    quantum *ratio*, not a rate cap). The idle gaps between a throttled
    tenant's quanta are real holes in the port timeline, so a
    full-weight read arriving mid-way through a multi-second repair
    transfer slots into the next hole instead of waiting for the whole
    thing — preemption at quantum granularity, the way production
    traffic shapers (DRR/WFQ schedulers) bound repair interference.

Multi-tenancy: sharing is governed by ``tenant_weights``, a map from an
arbitrary hashable tenant id to a weight in (0, 1]. Each (port, tenant)
pair keeps its own eligibility cursor, so any number of tenants share a
link in proportion to their weights. The original two-class interface is
a compatibility shim over this: ``background_share`` seeds the weight of
the ``"repair"`` tenant (and the legacy ``BACKGROUND`` int id), while
``FOREGROUND``/``"foreground"`` stay at weight 1.0. A ``Transfer`` names
its tenant either via ``tenant`` or via the legacy ``priority`` field.

Accounting: per-tenant bytes/busy/makespan (``class_bytes`` et al., keyed
by tenant id), per-tenant starvation (worst and total queueing delay
before a transfer's first quantum — ``tenant_wait_max``), and optional
per-transfer deadlines (``Transfer.deadline``; misses counted per tenant
in ``tenant_deadline_missed``).

Both modes conserve bytes exactly and an uncontended transfer finishes at
(essentially) the same time either way; they differ only in how tenants
interleave under contention.

Fail-slow (gray) degradation: ``set_node_rate(node, factor, direction)``
multiplies a node's effective send/recv bandwidth — both transfer modes
honour it, and ``send_backlog`` deliberately does NOT (it keeps quoting
the healthy rate, so the gateway's hedging deadline detects a slow
source as "taking far longer than the estimate" rather than silently
re-baselining around it).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

FIFO = "fifo"
QUANTUM = "quantum"


@dataclass(frozen=True)
class ClusterProfile:
    name: str
    node_bandwidth: float  # bytes/sec per node (send and receive)
    compute_scale: float  # multiplier on measured compute time

    @classmethod
    def network_critical(cls) -> "ClusterProfile":
        return cls(name="network-critical", node_bandwidth=12e6, compute_scale=1.0)

    @classmethod
    def computation_critical(cls) -> "ClusterProfile":
        # EC2 m1.small: fat links, weak CPU (paper: ~1.2GHz 2007 Xeon).
        return cls(name="computation-critical", node_bandwidth=250e6, compute_scale=8.0)


# Legacy priority classes for fabric sharing. Foreground (client reads)
# always runs at full link speed; background (repair/rebalance) may be
# throttled to a fraction of the link so client traffic keeps headroom —
# the knob every production repair pipeline exposes (HDFS-RAID's RaidNode
# caps, Ceph's osd_recovery_max_active etc.). These remain valid tenant
# ids; named tenants generalize them.
FOREGROUND = 0
BACKGROUND = 1

# Canonical tenant names used by the gateway dataplane. Any hashable id
# works; these two inherit default weights from ``background_share``.
FOREGROUND_TENANT = "foreground"
REPAIR_TENANT = "repair"


def shard_tenant(tenant, shard_id: int | None):
    """Shard-qualified fabric tenant id: ``"gold" -> "gold@s2"``. The
    sharded gateway tags every fabric submission with its shard so
    per-tenant accounting (class_bytes / class_makespan / deadline
    misses) and mid-run re-weighting (the repair pacer) get a private
    lane per shard. Identity for ``shard_id=None`` or non-str tenants
    (legacy int class ids keep their two-class semantics)."""
    if shard_id is None or not isinstance(tenant, str):
        return tenant
    return f"{tenant}@s{shard_id}"


def base_tenant(tenant):
    """Strip a shard qualifier: ``"gold@s2" -> "gold"``. Identity for
    unqualified ids."""
    if isinstance(tenant, str):
        head, sep, tail = tenant.rpartition("@s")
        if sep and tail.isdigit():
            return head
    return tenant


@dataclass
class Transfer:
    src_node: int
    dst_node: int
    nbytes: int
    not_before: float = 0.0  # dependency: source block exists at this time
    priority: int = FOREGROUND
    # Tenant id for weighted-fair sharing; None falls back to the legacy
    # ``priority`` field so two-class callers keep working unchanged.
    tenant: object = None
    # Optional completion deadline (absolute simulated seconds); the
    # simulator never drops a late transfer, it counts the miss per
    # tenant so SLO layers above can act on it.
    deadline: float | None = None
    # Observability context: (trace_id, parent_span_id) of the request
    # or repair that caused this transfer. When set (and the simulator
    # carries a tracer), the transfer emits a fabric-track span into
    # that trace. Appended last so positional construction is unchanged.
    ctx: tuple | None = None

    @property
    def effective_tenant(self) -> object:
        return self.priority if self.tenant is None else self.tenant


class _PortTimeline:
    """Busy intervals of one unidirectional port, sorted and disjoint.

    Supports first-fit gap search (``next_fit``) and interval insertion
    with adjacent-merge, so quantum-mode scheduling can place a transfer
    *inside* holes left by earlier-scheduled lower-priority quanta.
    """

    __slots__ = ("starts", "ends")

    def __init__(self):
        self.starts: list[float] = []
        self.ends: list[float] = []

    def next_fit(self, t: float, dur: float) -> float:
        """Earliest s >= t such that [s, s + dur) overlaps no interval.

        A nanosecond of tolerance keeps exact-fit holes usable — the
        weighted-fair spacing leaves holes of exactly one quantum, which
        strict float comparison would reject by one ulp."""
        return self.next_gap(t, dur)[0]

    def next_gap(self, t: float, min_dur: float) -> tuple[float, float]:
        """Earliest (s, length) with s >= t, [s, s + min_dur) free, and
        ``length`` the full free run from s (inf on the open tail) —
        lets the scheduler shrink a quantum into a sub-quantum hole
        instead of skipping it."""
        i = bisect.bisect_right(self.ends, t)
        for j in range(i, len(self.starts)):
            if self.starts[j] - t >= min_dur - 1e-9:
                return t, self.starts[j] - t
            t = max(t, self.ends[j])
        return t, float("inf")

    def occupy(self, start: float, end: float) -> None:
        i = bisect.bisect_left(self.starts, start)
        # merge with the previous interval when contiguous
        if i > 0 and self.ends[i - 1] == start:
            if i < len(self.starts) and end == self.starts[i]:
                # bridges two intervals: fuse all three
                self.ends[i - 1] = self.ends[i]
                del self.starts[i], self.ends[i]
            else:
                self.ends[i - 1] = end
            return
        if i < len(self.starts) and end == self.starts[i]:
            self.starts[i] = start
            return
        self.starts.insert(i, start)
        self.ends.insert(i, end)


# Public name: the interval timeline is shared infrastructure — the
# gateway's EnginePool schedules decode engines on the same structure
# the fabric schedules ports on (earliest-fit into holes).
PortTimeline = _PortTimeline


@dataclass
class NetSimulator:
    """Event-ordered per-node bandwidth simulator with weighted-fair tenants.

    Each node has unit-bandwidth send and receive ports; a transfer
    occupies both, starting no earlier than its dependency time. All
    tenants share the SAME port timelines — repair traffic and client
    reads contend on one fabric instead of running in separate
    universes. How they interleave is governed by ``mode`` (see the
    module docstring): ``quantum`` (default) schedules fixed-size
    full-rate quanta with per-(port, tenant) weighted-fair cursors so
    full-weight traffic preempts long throttled transfers at quantum
    boundaries; ``fifo`` reproduces the PR-1 hold-the-port-until-done
    model with throttled tenants rate-capped at their weight.

    ``tenant_weights`` maps tenant id -> weight in (0, 1]; tenants not in
    the map run at weight 1.0. ``background_share`` is the two-class
    compatibility shim: it seeds the weight of the ``"repair"`` tenant
    and the legacy ``BACKGROUND`` int id (explicit ``tenant_weights``
    entries win).

    Per-tenant byte/busy/makespan accounting feeds the gateway's
    interference metrics; per-tenant starvation (queueing delay before a
    transfer's first quantum) and deadline-miss counters feed its SLO
    admission controller.
    """

    profile: ClusterProfile
    background_share: float = 1.0  # quantum ratio (fifo: rate fraction)
    mode: str = QUANTUM
    quantum_bytes: int = 65536  # quantum-mode scheduling granule
    tenant_weights: dict | None = None  # tenant id -> weight in (0, 1]
    send_free: dict[int, float] = field(default_factory=dict)
    recv_free: dict[int, float] = field(default_factory=dict)
    total_bytes: int = 0
    makespan: float = 0.0
    class_bytes: dict = field(default_factory=dict)  # tenant -> bytes
    class_busy: dict = field(default_factory=dict)  # tenant -> busy secs
    class_makespan: dict = field(default_factory=dict)  # tenant -> max end
    tenant_wait_max: dict = field(default_factory=dict)  # worst queue delay
    tenant_wait_sum: dict = field(default_factory=dict)
    tenant_transfers: dict = field(default_factory=dict)
    tenant_deadline_missed: dict = field(default_factory=dict)
    tenant_deadline_met: dict = field(default_factory=dict)
    # Optional span sink (repro_torch.obs.Tracer): transfers whose ``ctx`` is
    # set emit fabric-track spans into it. Observation-only — the
    # schedule is byte-identical with or without a tracer attached.
    tracer: object = None
    # interned ("fabric", "portN") track tuples — xfer spans are the
    # hottest emission site, one per transfer
    _port_tracks: dict = field(default_factory=dict)
    # fail-slow (gray) degradation: ("s"|"r", node) -> rate factor in
    # (0, 1]. A transfer runs at node_bandwidth x min(send-side factor,
    # recv-side factor) — the slow NIC is the bottleneck of the path.
    _node_rate: dict = field(default_factory=dict)

    def __post_init__(self):
        # weight 0 would mean "tenant paused" — this event model cannot
        # express it (every scheduled transfer must complete)
        if not 0.0 < self.background_share <= 1.0:
            raise ValueError(
                f"background_share must be in (0, 1], got {self.background_share}"
            )
        if self.mode not in (FIFO, QUANTUM):
            raise ValueError(f"mode must be 'fifo' or 'quantum', got {self.mode!r}")
        if self.quantum_bytes <= 0:
            raise ValueError(f"quantum_bytes must be positive, got {self.quantum_bytes}")
        # compat shim: the two legacy classes are just two pre-seeded
        # tenants — background_share becomes the "repair" weight
        weights = {
            FOREGROUND: 1.0,
            FOREGROUND_TENANT: 1.0,
            BACKGROUND: self.background_share,
            REPAIR_TENANT: self.background_share,
        }
        if self.tenant_weights:
            for tenant, w in self.tenant_weights.items():
                if not 0.0 < w <= 1.0:
                    raise ValueError(
                        f"tenant weight must be in (0, 1], got {tenant!r}: {w}"
                    )
                weights[tenant] = w
        self._weights = weights
        self._send: dict[int, _PortTimeline] = {}
        self._recv: dict[int, _PortTimeline] = {}
        # per-(direction, node, tenant) eligibility cursor: a weight-w
        # tenant may claim its next quantum on a port no earlier than
        # (previous quantum start + dur/w), so the ratio holds across a
        # STREAM of small transfers too, not just within one big one
        self._class_cursor: dict[tuple, float] = {}
        # latest end of any FULL-weight quantum per send port: weight-1.0
        # reservations are not preemptible by anyone, so they bound every
        # tenant's admission-time backlog estimate (send_backlog)
        self._fw_send_end: dict[int, float] = {}
        # smallest usable hole: an eighth of a quantum bounds the chunk
        # count per transfer while letting fragmented timelines (tenants
        # with incommensurate periods) stay work-conserving
        self._granule = max(1, self.quantum_bytes // 8)
        # set once any weight<1 transfer is scheduled; until then the
        # timelines are hole-free and weight-1.0 transfers can take the
        # O(1) contiguous fast path (schedule-identical to chunking)
        self._seen_throttled = False

    def set_node_rate(
        self, node: int, factor: float, direction: str = "both"
    ) -> None:
        """Fail-slow injection actuator: degrade (or restore) a node's
        effective link rate. ``factor`` multiplies the healthy bandwidth
        for transfers the node participates in; 1.0 restores full speed.
        ``direction`` is ``"send"``, ``"recv"`` or ``"both"`` (a
        SlowNicEvent degrades one side, a SlowNodeEvent both). Applies to
        transfers scheduled AFTER the call — reservations already placed
        keep their timings, mirroring ``set_tenant_weight``."""
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"rate factor must be in (0, 1], got {factor}")
        if direction not in ("send", "recv", "both"):
            raise ValueError(f"direction must be send|recv|both, got {direction!r}")
        sides = ("s", "r") if direction == "both" else (direction[0],)
        for side in sides:
            if factor >= 1.0:
                self._node_rate.pop((side, int(node)), None)
            else:
                self._node_rate[(side, int(node))] = float(factor)

    def node_rate(self, node: int, direction: str = "send") -> float:
        """Current rate factor of one side of a node (1.0 = healthy)."""
        return self._node_rate.get((direction[0], int(node)), 1.0)

    def _link_rate(self, src_node: int, dst_node: int) -> float:
        if not self._node_rate:  # healthy fast path
            return 1.0
        return min(
            self._node_rate.get(("s", src_node), 1.0),
            self._node_rate.get(("r", dst_node), 1.0),
        )

    def set_tenant_weight(self, tenant, weight: float) -> None:
        """Re-weight a tenant mid-run (the SLO-aware repair pacer's
        actuator). Applies to quanta scheduled AFTER the call; quanta
        already placed on the timelines keep their reservations, so the
        change is a policy update, not a retroactive rewrite of history."""
        if not 0.0 < weight <= 1.0:
            raise ValueError(
                f"tenant weight must be in (0, 1], got {tenant!r}: {weight}"
            )
        self._weights[tenant] = weight

    def weight_of(self, tenant) -> float:
        """Fair-share weight of a tenant. Unregistered NAMED tenants run
        at full weight; unregistered int ids keep the legacy two-class
        contract (any priority other than FOREGROUND was throttled to
        ``background_share``), so pre-tenant callers using custom class
        ids keep their throttle."""
        w = self._weights.get(tenant)
        if w is not None:
            return w
        # shard-qualified tenants ("gold@s2") inherit the base tenant's
        # weight unless the shard lane was re-weighted explicitly — a
        # shard tag changes accounting, not policy
        base = base_tenant(tenant)
        if base is not tenant:
            w = self._weights.get(base)
            if w is not None:
                return w
            tenant = base
        if isinstance(tenant, int):
            return self.background_share
        return 1.0

    def transfer(self, t: Transfer) -> float:
        """Schedule a transfer; returns its completion time (seconds)."""
        tenant = t.effective_tenant
        if self.mode == QUANTUM:
            end, busy, first_start = self._transfer_quantum(t, tenant)
        else:
            end, busy, first_start = self._transfer_fifo(t, tenant)
        self.total_bytes += t.nbytes
        self.makespan = max(self.makespan, end)
        self.class_bytes[tenant] = self.class_bytes.get(tenant, 0) + t.nbytes
        self.class_busy[tenant] = self.class_busy.get(tenant, 0.0) + busy
        self.class_makespan[tenant] = max(
            self.class_makespan.get(tenant, 0.0), end
        )
        # starvation accounting: how long the transfer queued before its
        # first byte moved (beyond its own dependency time)
        wait = max(0.0, first_start - t.not_before)
        self.tenant_wait_max[tenant] = max(
            self.tenant_wait_max.get(tenant, 0.0), wait
        )
        self.tenant_wait_sum[tenant] = self.tenant_wait_sum.get(tenant, 0.0) + wait
        self.tenant_transfers[tenant] = self.tenant_transfers.get(tenant, 0) + 1
        if t.deadline is not None:
            key = (
                "tenant_deadline_missed" if end > t.deadline else "tenant_deadline_met"
            )
            counter = getattr(self, key)
            counter[tenant] = counter.get(tenant, 0) + 1
        if (
            t.ctx is not None
            and self.tracer is not None
            and getattr(self.tracer, "enabled", False)
        ):
            tid, pid = t.ctx
            track = self._port_tracks.get(t.src_node)
            if track is None:
                track = self._port_tracks[t.src_node] = (
                    "fabric",
                    f"port{t.src_node}",
                )
            self.tracer.span(
                "xfer",
                first_start,
                end,
                tid,
                pid,
                track=track,
                src=t.src_node,
                dst=t.dst_node,
                bytes=t.nbytes,
                tenant=tenant,
                wait=wait,
            )
        return end

    def send_backlog(self, node: int, tenant, now: float) -> float:
        """How far beyond ``now`` this tenant's next quantum on the
        node's send port is already committed — the admission-estimator
        view of fabric queueing. Quantum mode takes the max of the
        tenant's own fair-share cursor and the port's full-weight
        horizon (weight-1.0 reservations preempt nobody and are
        preemptible by nobody, so they delay every tenant; throttled
        tenants' reservations leave preemptible holes and only count
        against their own cursor). Fifo mode reads the port's
        hold-until-done horizon."""
        if self.mode == QUANTUM:
            cursor = self._class_cursor.get(("s", node, tenant), 0.0)
            fw = self._fw_send_end.get(node, 0.0)
            return max(0.0, max(cursor, fw) - now)
        return max(0.0, self.send_free.get(node, 0.0) - now)

    def deadline_miss_rate(self, tenant) -> float:
        missed = self.tenant_deadline_missed.get(tenant, 0)
        met = self.tenant_deadline_met.get(tenant, 0)
        return missed / (missed + met) if (missed + met) else 0.0

    # -- fifo: the PR-1 hold-until-done model ---------------------------------
    def _transfer_fifo(self, t: Transfer, tenant) -> tuple[float, float, float]:
        bw = (
            self.profile.node_bandwidth
            * self.weight_of(tenant)
            * self._link_rate(t.src_node, t.dst_node)
        )
        start = max(
            t.not_before,
            self.send_free.get(t.src_node, 0.0),
            self.recv_free.get(t.dst_node, 0.0),
        )
        dur = t.nbytes / bw
        end = start + dur
        self.send_free[t.src_node] = end
        self.recv_free[t.dst_node] = end
        return end, dur, start

    # -- quantum: weighted-fair preemptive sharing ----------------------------
    def _transfer_quantum(self, t: Transfer, tenant) -> tuple[float, float, float]:
        if self._node_rate:
            s_f = self._node_rate.get(("s", t.src_node), 1.0)
            r_f = self._node_rate.get(("r", t.dst_node), 1.0)
            if min(s_f, r_f) < 1.0:
                return self._transfer_degraded(t, tenant, s_f, r_f)
        bw = self.profile.node_bandwidth
        share = self.weight_of(tenant)
        src = self._send.setdefault(t.src_node, _PortTimeline())
        dst = self._recv.setdefault(t.dst_node, _PortTimeline())
        ck_s = ("s", t.src_node, tenant)
        ck_r = ("r", t.dst_node, tenant)
        cursors = self._class_cursor
        if share < 1.0:
            self._seen_throttled = True
        remaining = float(t.nbytes)
        end = t.not_before
        first_start = t.not_before
        busy = 0.0
        first = True
        # Full-share fast path while no throttled tenant has ever run:
        # the timelines are hole-free, so chunking into quanta would
        # produce one contiguous reservation anyway — schedule the whole
        # transfer in one step instead of nbytes/quantum_bytes of them.
        # (Once holes can exist, per-quantum placement is what lets this
        # transfer preempt into them, so the loop is mandatory.)
        chunk_cap = (
            t.nbytes
            if share == 1.0 and not self._seen_throttled
            else self.quantum_bytes
        )
        # Exit threshold in the same units as next_gap's acceptance
        # tolerance (1e-9 s, converted to bytes): a residual below it
        # would make min_dur sub-tolerance, where next_gap can accept
        # zero-length gaps and the loop would stop making progress.
        while remaining > bw * 1e-9:
            want_dur = min(remaining, chunk_cap) / bw
            # Sub-quantum holes are usable down to the granule: two
            # tenants with incommensurate periods fragment the timeline
            # into holes smaller than a full quantum, and a scheduler
            # that can only place whole quanta would starve a light
            # tenant out of exactly the fragments its weight entitles it
            # to (non-work-conserving). Shrinking the chunk to the hole
            # keeps delivered bytes proportional to the weights.
            min_dur = min(remaining, self._granule) / bw
            # each chunk transmits at FULL rate; weighted-fair spacing
            # makes the tenant's next chunk on these ports eligible only
            # dur/share later, so a weight-w tenant consumes at most w of
            # the link in steady state while the (1-w) holes it leaves
            # are real gaps other tenants preempt into.
            earliest = max(
                t.not_before, cursors.get(ck_s, 0.0), cursors.get(ck_r, 0.0)
            )
            start, avail = self._find_gap(src, dst, earliest, min_dur)
            dur = min(want_dur, avail)
            remaining -= dur * bw
            src.occupy(start, start + dur)
            dst.occupy(start, start + dur)
            if first:
                first_start = start
                first = False
            end = start + dur
            busy += dur
            # Virtual-clock eligibility: advance each cursor from its
            # PREVIOUS value, not from the actual (possibly collision-
            # delayed) start — a tenant knocked off its token schedule by
            # another's quantum may claim its next one on time instead of
            # compounding the delay (rate-drift-free weighted fairness).
            # Re-anchoring at the chunk's end bounds the catch-up
            # credit: a long-idle or long-blocked tenant cannot burst
            # past back-to-back quanta.
            for ck in (ck_s, ck_r):
                cursors[ck] = max(cursors.get(ck, 0.0) + dur / share, end)
        # keep the scalar summaries coherent for introspection/debugging
        self.send_free[t.src_node] = max(self.send_free.get(t.src_node, 0.0), end)
        self.recv_free[t.dst_node] = max(self.recv_free.get(t.dst_node, 0.0), end)
        if share == 1.0:
            self._fw_send_end[t.src_node] = max(
                self._fw_send_end.get(t.src_node, 0.0), end
            )
        return end, busy, first_start

    # -- degraded (fail-slow) paths -------------------------------------------
    def _transfer_degraded(
        self, t: Transfer, tenant, s_f: float, r_f: float
    ) -> tuple[float, float, float]:
        """Gray-path scheduling: one contiguous reservation at the
        bottleneck rate ``min(s_f, r_f)``. The bottleneck side's port is
        saturated for the whole stretched duration; the HEALTHY side is
        only busy for its own wire time, anchored at the transfer's END
        (in-order delivery: the receiver hands the object off at
        last-byte time). A stream trickling in from a fail-slow sender
        must not head-of-line block the receiver's NIC — otherwise every
        hedged alternate fetch would queue behind the very transfer it
        is racing, and fail-slow would be indistinguishable from
        receiver congestion.

        Weighted-fair quantum interleaving is bypassed on the stretched
        reservation: the trickle runs far below the port's healthy
        capacity, so spacing it against healthy tenants' quanta would
        model contention it does not cause. Later transfers preempt into
        the healthy-side head hole through the normal gap search."""
        bw = self.profile.node_bandwidth
        share = self.weight_of(tenant)
        rate = min(s_f, r_f)
        src = self._send.setdefault(t.src_node, _PortTimeline())
        dst = self._recv.setdefault(t.dst_node, _PortTimeline())
        cursors = self._class_cursor
        ck_s = ("s", t.src_node, tenant)
        ck_r = ("r", t.dst_node, tenant)
        earliest = max(
            t.not_before, cursors.get(ck_s, 0.0), cursors.get(ck_r, 0.0)
        )
        dur = t.nbytes / (bw * rate * share)
        if s_f <= r_f:
            bneck, other = src, dst
            o_busy = t.nbytes / (bw * r_f)
        else:
            bneck, other = dst, src
            o_busy = t.nbytes / (bw * s_f)
        # joint placement: full stretched hole on the bottleneck port,
        # tail slice on the healthy port; each miss pushes the search
        # strictly later, so the loop terminates like _find_gap's
        probe = earliest
        while True:
            b_start, _ = bneck.next_gap(probe, dur)
            end = b_start + dur
            o_start, _ = other.next_gap(max(0.0, end - o_busy), o_busy)
            if o_start <= end - o_busy + 1e-9:
                break
            probe = max(o_start + o_busy - dur, b_start + 1e-9)
        bneck.occupy(b_start, end)
        other.occupy(end - o_busy, end)
        # the tail-anchored occupation leaves a real hole on the healthy
        # port: flip chunked scheduling on so full-weight transfers can
        # preempt into it instead of skipping it
        self._seen_throttled = True
        # eligibility cursors: the bottleneck side is saturated until the
        # stretched end, so its cursor re-anchors there like any full
        # reservation; the healthy side only consumed its wire time, and
        # flooring ITS cursor at the stretched end would let the trickle
        # head-of-line block the tenant's other traffic through the back
        # door the occupation hole just opened
        if bneck is src:
            cursors[ck_s] = max(cursors.get(ck_s, 0.0) + dur / share, end)
            cursors[ck_r] = cursors.get(ck_r, 0.0) + o_busy / share
        else:
            cursors[ck_r] = max(cursors.get(ck_r, 0.0) + dur / share, end)
            cursors[ck_s] = cursors.get(ck_s, 0.0) + o_busy / share
        self.send_free[t.src_node] = max(self.send_free.get(t.src_node, 0.0), end)
        self.recv_free[t.dst_node] = max(self.recv_free.get(t.dst_node, 0.0), end)
        if share == 1.0:
            self._fw_send_end[t.src_node] = max(
                self._fw_send_end.get(t.src_node, 0.0), end
            )
        return end, dur, b_start

    @staticmethod
    def _find_gap(
        src: _PortTimeline, dst: _PortTimeline, t: float, min_dur: float
    ) -> tuple[float, float]:
        """Earliest (start, length) of a >= min_dur hole on BOTH ports."""
        while True:
            t1, g1 = src.next_gap(t, min_dur)
            t2, g2 = dst.next_gap(t1, min_dur)
            if t2 == t1:
                return t1, min(g1, g2)
            t = t2
