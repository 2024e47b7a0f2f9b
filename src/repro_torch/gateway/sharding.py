"""Sharded multi-gateway front door: N ``ObjectGateway`` shards over
one ``BlockStore``/``NetSimulator`` fabric and one ``MetadataPlane``.

This is the horizontal counterpart to the ragged tile dataplane: instead
of one bigger launch, N serving processes. Each shard owns a private data
path — LRU/negative cache, decode/encode engine pool, coalescer,
planner, repair fixer, client-NIC stripe, hedge ledger — while the
namespace (stripe maps, ground truth, tombstones, fault bookkeeping)
lives on the shared metadata plane. Requests route by consistent hash
of the object id (``MetadataPlane.directory``); per-shard SLO admission
runs inside each shard's own flush exactly as standalone.

The merged event loop preserves the single-gateway serve() semantics
over N shards: requests coalesce into per-shard homogeneous batch
windows; cluster events, due repairs and scrub ticks interleave with
the request stream in global time order, with every open window flushed
before an event applies so planning sees pre-event state. A cluster
event is applied ONCE (store/fabric mutations are global; negative-
cache fan-out goes through the plane) and its repair trigger enqueues
on EVERY live shard — each shard repairs only the groups the directory
hashes to it, so N shards split the repair backlog.

Whole-shard death (``ShardFailEvent``) is consumed here, mid-run: the
dead shard's open window drains, its ring points leave the directory
(only ITS ranges move — survivors keep every object they already
owned), its cache leaves the coherence fan-out, and its pending repair
work is redistributed. Storage is untouched, so failover loses zero
blocks; subsequent requests for the dead shard's namespace route to
survivors.

``serve`` returns one ``GatewayReport`` merged across shards
(``GatewayReport.merged``), so existing report consumers and bench
blocks read a sharded run through the same pinned keys;
``last_reports`` keeps the per-shard reports for scaling analysis.
"""

from __future__ import annotations

from repro_torch.core.product_code import CoreCode
from repro_torch.gateway.gateway import GatewayConfig, GatewayReport, ObjectGateway
from repro_torch.gateway.metadata import MetadataPlane
from repro_torch.gateway.workload import Request, ShardFailEvent
from repro_torch.storage.netmodel import ClusterProfile

import numpy as np


class ShardedGateway:
    """N-shard gateway cluster behind one serve() front door."""

    def __init__(
        self,
        code: CoreCode,
        profile: ClusterProfile,
        num_nodes: int,
        num_shards: int,
        config: GatewayConfig | None = None,
        vnodes: int = 64,
    ):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.config = config or GatewayConfig()
        self.meta = MetadataPlane(shard_ids=range(num_shards), vnodes=vnodes)
        # shard 0 constructs the shared store + fabric from the config;
        # the rest attach to them
        first = ObjectGateway(
            code, profile, num_nodes, self.config, meta=self.meta, shard_id=0
        )
        self.store = first.store
        self.sim = first.sim
        self.shards: dict[int, ObjectGateway] = {0: first}
        for sid in range(1, num_shards):
            self.shards[sid] = ObjectGateway(
                code,
                profile,
                num_nodes,
                self.config,
                store=self.store,
                sim=self.sim,
                meta=self.meta,
                shard_id=sid,
            )
        self.dead_shards: set[int] = set()
        # cluster-wide scrub schedule (one scrubber cluster-wide — the
        # lowest live shard runs the tick; running N would N-plicate
        # maintenance reads over one shared store)
        self._scrub_next: float | None = self.config.scrub_interval
        self.last_reports: dict[int, GatewayReport] = {}

    # -- topology ---------------------------------------------------------------
    def live_shards(self) -> list[int]:
        return [sid for sid in self.shards if sid not in self.dead_shards]

    def shard_of(self, object_id: int) -> int:
        """Which live shard serves this object right now."""
        return self.meta.shard_for(object_id)

    def _lead(self) -> ObjectGateway:
        return self.shards[min(self.live_shards())]

    # -- namespace load ---------------------------------------------------------
    def load_objects(self, objects: np.ndarray) -> None:
        """Bulk-load the namespace (shared: any shard can do it)."""
        self._lead().load_objects(objects)

    # -- failover ---------------------------------------------------------------
    def _fail_shard(self, sid: int, at: float, report: GatewayReport) -> None:
        if sid not in self.shards:
            raise ValueError(f"ShardFailEvent for unknown shard {sid}")
        if sid in self.dead_shards:
            return
        dead = self.shards[sid]
        self.dead_shards.add(sid)
        if not self.live_shards():
            raise RuntimeError("ShardFailEvent killed the last live shard")
        # remove ONLY the dead shard's ring points: its ranges fail over
        # to survivors, every other object keeps its owner
        self.meta.directory.remove_shard(sid)
        # its cache leaves the coherence fan-out (nothing to keep fresh)
        self.meta.unregister_cache(dead.cache)
        # pending repair work it owned re-hashes to survivors — hand its
        # due-times to every survivor; a shard that ends up owning none
        # of the missing groups just no-ops the run
        if dead._repair_queue:
            for osid in self.live_shards():
                q = self.shards[osid]._repair_queue
                for entry in dead._repair_queue:
                    if entry not in q:
                        q.append(entry)
                q.sort()
            dead._repair_queue.clear()
        report.metrics.counter("shard_failovers").inc()
        report.metrics.gauge("live_shards").set(len(self.live_shards()))

    # -- serving ----------------------------------------------------------------
    def serve(
        self,
        requests: list[Request],
        failures: list | None = None,
    ) -> GatewayReport:
        """Route and serve a request trace across the live shards.
        Accepts the same event mix as ``ObjectGateway.serve`` plus
        ``ShardFailEvent``. Returns the cross-shard merged report;
        per-shard reports land in ``last_reports``."""
        cfg = self.config
        reports = {
            sid: GatewayReport(record_requests=cfg.record_requests)
            for sid in self.shards
        }
        events = sorted(failures or [], key=lambda f: f.time)
        reqs = sorted(requests, key=lambda r: r.time)

        batches: dict[int, list[Request]] = {sid: [] for sid in self.shards}
        deadlines: dict[int, float | None] = {sid: None for sid in self.shards}
        kinds: dict[int, str | None] = {sid: None for sid in self.shards}
        fi = 0

        def flush_shard(sid: int) -> None:
            batch = batches[sid]
            if batch:
                gw = self.shards[sid]
                if kinds[sid] == "put":
                    gw._flush_puts(batch, reports[sid])
                else:
                    gw._flush(batch, reports[sid])
            batches[sid], deadlines[sid], kinds[sid] = [], None, None

        def flush_all() -> None:
            for sid in self.live_shards():
                flush_shard(sid)

        def boundary_events(now: float | None) -> None:
            """Apply cluster / repair / scrub work due before ``now``
            (None => all remaining), in global time order across every
            live shard — the merged analogue of the single gateway's
            boundary loop."""
            nonlocal fi
            while True:
                next_evt = events[fi].time if fi < len(events) else None
                rep_sid, next_rep = None, None
                for sid in self.live_shards():
                    q = self.shards[sid]._repair_queue
                    if q and (next_rep is None or q[0][0] < next_rep):
                        rep_sid, next_rep = sid, q[0][0]
                next_scrub = self._scrub_next if now is not None else None
                cands = [
                    t for t in (next_evt, next_rep, next_scrub) if t is not None
                ]
                if not cands:
                    return
                t_evt = min(cands)
                if now is not None and t_evt > now:
                    return
                flush_all()
                if next_evt is not None and t_evt == next_evt:
                    evt = events[fi]
                    fi += 1
                    if isinstance(evt, ShardFailEvent):
                        lead = min(self.live_shards())
                        self._fail_shard(evt.shard, evt.time, reports[lead])
                        continue
                    # apply ONCE via the lead shard: store/fabric effects
                    # are global, cache effects fan out through the plane
                    lead = min(self.live_shards())
                    wants_repair = self.shards[lead]._apply_cluster_event(
                        evt, reports[lead]
                    )
                    if wants_repair and cfg.repair_on_failure:
                        # every live shard gets the trigger; ownership
                        # filtering inside _background_repair splits the
                        # actual work by group hash
                        for sid in self.live_shards():
                            q = self.shards[sid]._repair_queue
                            q.append((evt.time + cfg.repair_delay, evt.node))
                            q.sort()
                elif next_rep is not None and t_evt == next_rep:
                    gw = self.shards[rep_sid]
                    t_rep, _node = gw._repair_queue.pop(0)
                    if gw._background_repair(t_rep, reports[rep_sid]):
                        gw._repair_queue.append(
                            (t_rep + cfg.repair_respacing, -1)
                        )
                        gw._repair_queue.sort()
                else:
                    self._scrub_next = t_evt + cfg.scrub_interval
                    lead = min(self.live_shards())
                    self.shards[lead]._run_scrub(t_evt, reports[lead])

        for req in reqs:
            boundary_events(req.time)
            sid = self.meta.shard_for(req.object_id)
            if req.kind == "delete":
                # namespace barrier: every shard's open window must see
                # pre-delete state (any shard may hold reads planned
                # against this object's group)
                flush_all()
                gw = self.shards[sid]
                reports[sid].add_record(gw._handle_delete(req, reports[sid]))
                continue
            kind = "put" if req.kind == "put" else "get"
            # close any shard's window whose deadline passed — keeps
            # fabric submissions near time order across shards, like the
            # single gateway's one-window deadline does
            for osid in self.live_shards():
                if batches[osid] and req.time > deadlines[osid]:
                    flush_shard(osid)
            if batches[sid] and kinds[sid] != kind:
                flush_shard(sid)
            if not batches[sid]:
                deadlines[sid] = req.time + cfg.batch_window
                kinds[sid] = kind
            batches[sid].append(req)
        flush_all()
        boundary_events(None)
        for sid in self.live_shards():
            self.shards[sid]._finalize_report(reports[sid])
        self.last_reports = dict(reports)
        return GatewayReport.merged(list(reports.values()))

    # -- drains / audits (cluster-wide, over the shared namespace) --------------
    def seal_flush(self, at: float = 0.0) -> int:
        """Drain every live shard's open seal buffer; returns total
        groups sealed."""
        return sum(
            self.shards[sid].seal_flush(at) for sid in self.live_shards()
        )

    def audit_durability(self) -> dict:
        """Namespace-wide durability audit (shared store + maps, so any
        live shard computes the same answer)."""
        return self._lead().audit_durability()

    def audit_parity(self) -> dict:
        return self._lead().audit_parity()
