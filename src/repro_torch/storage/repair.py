"""BlockFixer: the repair engine over the simulated block store.

Three modes reproduce the paper's §8 comparison:

  * ``hdfs_raid``      — classic HDFS-RAID: discovers failures one at a
    time (no Opt2) and, per failure, fetches *all* remaining blocks of
    the stripe (generator-polynomial style, no Opt1), decodes, and
    regenerates just that block.
  * ``hdfs_raid_opt``  — with the paper's two optimizations: Opt1 fetch
    exactly k blocks; Opt2 detect all failures of a stripe up front and
    repair them with a single decode.
  * ``core``           — full §6 pipeline: failure-matrix population →
    independent clusters → recoverability check → repair scheduling
    (row-first / column-first / RGS) → execution with XOR verticals and
    RS horizontals.

Bytes moved are exact (they must match the analytical numbers — the
paper applies the same cross-check in §8); network time is simulated by
``NetSimulator``; compute time is *measured* on the real codec math
(on ``device``, synchronized before each clock read) and scaled by the
cluster profile.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.coding import gf256
from repro_torch.core.failure_matrix import independent_clusters
from repro_torch.core.product_code import CoreCode, CoreCodec
from repro_torch.core.recoverability import is_recoverable
from repro_torch.core.scheduling import SCHEDULERS, RepairStep
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.backend import resolve_device, synchronize
from repro_torch.obs import host
from repro_torch.storage.blockstore import BlockStore
from repro_torch.storage.netmodel import ClusterProfile, NetSimulator, Transfer


@dataclass
class RepairReport:
    mode: str
    blocks_fetched: int = 0
    bytes_fetched: int = 0
    blocks_repaired: int = 0
    network_time: float = 0.0
    compute_time: float = 0.0
    schedule: str = ""
    recovered: bool = True

    @property
    def total_time(self) -> float:
        return self.network_time + self.compute_time


class UnrecoverableError(RuntimeError):
    pass


@dataclass
class PacingController:
    """SLO-aware closed-loop repair pacing.

    Maps observed foreground latency headroom to the repair tenant's
    fabric weight and decode-engine share: when the protected tier's p99
    approaches its SLO the repair share backs off toward ``min_share``
    (foreground keeps its headroom); when the tier is comfortably inside
    its target — or there is no foreground traffic at all — repair
    accelerates toward ``max_share`` so MTTR stays bounded. An MTTR
    urgency term overrides the backoff as a repair drags past
    ``mttr_target``: durability pressure eventually outranks latency
    pressure, which is what keeps paced MTTR within a constant factor of
    repair-at-full-weight no matter how long a foreground surge lasts.

    The controller is pure policy — callers feed it observations
    (``share(...)``) and apply the result to the fabric
    (``NetSimulator.set_tenant_weight``) and the engine pool.
    ``min_share`` also acts as the mechanical MTTR guard: repair fabric
    time at weight w is ~1/w of full-weight time, so min_share=0.5 bounds
    the paced fabric slowdown at 2x even before urgency kicks in.
    """

    min_share: float = 0.5  # floor while foreground SLOs are at risk
    max_share: float = 1.0  # ceiling when idle / healthy
    # headroom = (slo - p99) / slo. At or below the floor the repair runs
    # at min_share; at or above the ceiling it runs at max_share; linear
    # in between (a proportional controller — no integral term, so a
    # stale observation cannot wind up).
    headroom_floor: float = 0.0
    headroom_ceiling: float = 0.5
    # When a repair has been outstanding longer than mttr_target seconds,
    # urgency ramps the share back up regardless of foreground pressure
    # (reaching max_share at 2x the target).
    mttr_target: float | None = None

    def __post_init__(self):
        if not 0.0 < self.min_share <= self.max_share <= 1.0:
            raise ValueError(
                f"need 0 < min_share <= max_share <= 1, got "
                f"{self.min_share}/{self.max_share}"
            )
        if not self.headroom_floor < self.headroom_ceiling:
            raise ValueError("headroom_floor must be < headroom_ceiling")

    def share(
        self,
        observed_p99: float | None,
        slo: float | None,
        outstanding_for: float = 0.0,
    ) -> float:
        """Repair share for the next repair step.

        ``observed_p99``: the protected tier's recent p99 (None => no
        recent foreground traffic, i.e. idle). ``slo``: its latency
        target (None => nothing to protect). ``outstanding_for``: how
        long the oldest unrepaired loss has been waiting (seconds)."""
        if slo is None or observed_p99 is None:
            base = self.max_share
        else:
            headroom = (slo - observed_p99) / slo
            frac = (headroom - self.headroom_floor) / (
                self.headroom_ceiling - self.headroom_floor
            )
            frac = min(1.0, max(0.0, frac))
            base = self.min_share + frac * (self.max_share - self.min_share)
        if self.mttr_target is not None and outstanding_for > self.mttr_target:
            urgency = min(1.0, outstanding_for / self.mttr_target - 1.0)
            base = max(base, self.min_share + urgency * (self.max_share - self.min_share))
        return base


@dataclass
class Scrubber:
    """Background integrity scrubber: walks the store's blocks at a paced
    rate recomputing checksums, so LATENT corruption (a bit flip nobody
    has read yet) is found and queued for repair before a foreground GET
    trips over it — the proactive half of the corruption-as-erasure
    plane (the reactive half is the gateway's fetch-time verify).

    Pure detection: ``scan`` verifies up to ``budget`` blocks from a
    persistent cursor (round-robin over the key space, wrapping) and
    returns the keys that failed — the owner decides quarantine/repair.
    The per-tick budget is the pacing surface: the gateway multiplies
    ``blocks_per_run`` by the ``PacingController`` share, so scrubbing
    backs off exactly like repair when foreground SLOs are at risk."""

    store: BlockStore
    blocks_per_run: int = 64
    scanned: int = 0
    found: int = 0
    _cursor: int = 0

    def scan(self, budget: int | None = None) -> list:
        budget = self.blocks_per_run if budget is None else int(budget)
        keys = sorted(self.store.blocks.keys())
        if not keys or budget <= 0:
            return []
        budget = min(budget, len(keys))
        bad = []
        start = self._cursor % len(keys)
        for i in range(budget):
            key = keys[(start + i) % len(keys)]
            self.scanned += 1
            if not self.store.verify(key):
                bad.append(key)
        self._cursor = (start + budget) % len(keys)
        self.found += len(bad)
        return bad


@dataclass
class BlockFixer:
    store: BlockStore
    code: CoreCode
    profile: ClusterProfile
    mode: str = "core"  # hdfs_raid | hdfs_raid_opt | core
    scheduler: str = "rgs"  # row_first | column_first | rgs
    # Optional shared fabric: when ``sim`` is set, repair transfers are
    # scheduled on that simulator (at ``priority`` — any tenant id the
    # simulator's tenant_weights knows) instead of a private one, so they
    # contend with whatever else rides the fabric — the gateway runs
    # repair as the "repair" tenant here while client reads ride their
    # own tenants on the same NetSimulator.
    sim: NetSimulator | None = None
    priority: object = 0
    not_before: float = 0.0  # earliest start (failure-detection time)
    # Invoked with each BlockKey this fixer writes back, right after the
    # store write. The gateway uses it to re-price / refresh cache
    # entries whose underlying block just became a cheap store read
    # again (cost-aware eviction, gateway/cache.py).
    on_block_repaired: "Callable[[tuple], None] | None" = None
    # Observability (repro_torch.obs): when the owner sets ``tracer`` and
    # ``trace_ctx`` ((trace_id, parent_span_id)), repairs emit
    # repair-track spans and their fabric transfers emit port spans
    # into that trace. Observation-only.
    tracer: object = None
    trace_ctx: tuple | None = None
    # Code family (repro_torch.gateway.planner.CodeFamily). None or a "core"
    # family keeps the product-code modes above; a row family ("rs" /
    # "lrc") repairs through the family's repair_plan — LRC local steps
    # fetch ONLY the local group (k/2 survivors), not k blocks.
    family: object = None
    # Where the codec math runs: None/"cuda" is the card (raises without
    # CUDA), "cpu" the host.
    device: str | None = None

    def __post_init__(self):
        self.codec = CoreCodec(self.code, device=self.device)
        self._dev = resolve_device(self.device)
        self._timed = 0.0
        # every codec step's sources and rebuilt blocks pass through these
        pinned = self._dev.type == "cuda"
        self._sources = _Staging(pinned)
        self._rebuilt = _Staging(pinned)

    def _obs_ctx(self) -> tuple | None:
        """(trace_id, parent_id) when span emission is live, else None."""
        if (
            self.tracer is not None
            and getattr(self.tracer, "enabled", False)
            and self.trace_ctx is not None
        ):
            return self.trace_ctx
        return None

    def _sim(self) -> NetSimulator:
        sim = self.sim if self.sim is not None else NetSimulator(self.profile)
        # Baseline for duration accounting: on a shared fabric the class
        # makespan is cumulative across calls, so each call reports only
        # its own extension of it.
        self._net_baseline = sim.class_makespan.get(self.priority, 0.0)
        return sim

    def _net_time(self, sim: NetSimulator) -> float:
        end = sim.class_makespan.get(self.priority, 0.0)
        if self.sim is None:
            return end
        # shared fabric: duration of THIS repair, not the absolute clock
        start = max(self._net_baseline, self.not_before)
        return max(0.0, end - start)

    # -- timed codec ops ------------------------------------------------------
    def _stage(self, keys: list) -> torch.Tensor:
        """The blocks ``keys`` gathered, in that order, into the reused
        source buffer (pinned when the codec runs on the card, so their
        copy there is a DMA from it): a (sources, q) view, overwritten by
        the next step. The buffer is made at k blocks and grown only for
        a larger step."""
        with host.span("repair.fetch") as sp:
            arrays = [self.store.get(key) for key in keys]
            sp.nbytes = nbytes = len(arrays) * arrays[0].nbytes
            staged = self._sources.take(nbytes, least=self.code.k * arrays[0].nbytes)
            staged = staged.view(len(arrays), *arrays[0].shape)
            np.stack(arrays, out=staged.numpy())
        return staged

    def _measure(self, fn, *args):
        """``fn(*args)`` on the device, the last of ``args`` a staged tensor
        (``_stage``): copied from the reused buffer without blocking the
        host, and the result brought back through the other buffer into a
        host array of its own. The compute time billed is from the launch
        to the synchronize."""
        with host.span("repair.codec") as sp:
            *lead, staged = args
            blocks = staged.to(self._dev, non_blocking=True)
            synchronize(self._dev)
            t0 = time.perf_counter()
            out = fn(*lead, blocks)
            synchronize(self._dev)
            self._timed += (time.perf_counter() - t0) * self.profile.compute_scale
            sp.nbytes = out.nbytes
            back = self._rebuilt.take(out.nbytes).view(out.shape)
            back.copy_(out, non_blocking=True)
            synchronize(self._dev)
            return back.numpy().copy()

    def _xor(self, keys: list) -> np.ndarray:
        """The XOR of the blocks ``keys``: one block, (1, q)."""
        return self._measure(_xor_rows, self._stage(keys))

    def _product(self, coeffs: np.ndarray, keys: list) -> np.ndarray:
        """coeffs (M, K) @ the K blocks ``keys`` over GF(256), the keys in
        the order the coefficients weigh them: (M, q)."""
        return self._measure(_gf256_product, coeffs, self._stage(keys))

    # -- main entry ------------------------------------------------------------
    def fix_group(self, group_id: str, rows: int | None = None) -> RepairReport:
        """Detect and repair all missing blocks of a group."""
        self._timed = 0.0
        if (
            self.family is not None
            and getattr(self.family, "name", "core") != "core"
        ):
            return self._fix_family(group_id)
        rows = rows if rows is not None else self.code.rows
        cols = self.code.n
        if self.mode == "core":
            return self._fix_core(group_id, rows, cols)
        return self._fix_raid(group_id, rows, cols, optimized=self.mode == "hdfs_raid_opt")

    # -- row-family mode (rs / lrc via CodeFamily.repair_plan) -----------------
    def _fix_family(self, group_id: str) -> RepairReport:
        """Repair the group's single codeword row through the family's
        repair plan. LRC 'local' steps fetch ONLY the k/2 surviving
        members of the broken local group and XOR them — the locality
        win the bake-off bench measures against the RS baseline, whose
        every repair is a 'global' k-source GF(256) decode. Each step's
        sources are staged in the reused host buffer (``_stage``)."""
        fam = self.family
        report = RepairReport(mode=fam.name)
        cols = self.code.n
        failed = [
            c for c in range(cols) if not self.store.available((group_id, 0, c))
        ]
        if not failed:
            return report
        sim = self._sim()
        with host.span("repair.plan") as sp:
            plan = fam.repair_plan(set(failed))
            if plan is not None:
                # a global step reads the rows its coefficients weigh (the
                # plan's own sources: k independent survivors, in order)
                steps = []
                for kind, sources, repaired in plan:
                    coeffs = None
                    if kind != "local":
                        sources, coeffs = fam.code.repair_matrix(
                            np.asarray(sources), np.asarray(repaired)
                        )
                    steps.append((kind, [int(c) for c in sources], repaired, coeffs))
                sp.nbytes = sum(len(r) for _, _, r, _ in steps) * self.store.get(
                    (group_id, 0, steps[0][1][0])
                ).nbytes
        if plan is None:
            report.recovered = False
            report.network_time = self._net_time(sim)
            return report
        ctx = self._obs_ctx()
        descs = []
        # a block repaired by an earlier step may serve as a later step's
        # source; its bytes exist only once its own fetches landed
        repaired_ready: dict[int, float] = {}
        for kind, sources, repaired, coeffs in steps:
            keys = [(group_id, 0, c) for c in sources]
            block_bytes = self.store.get(keys[0]).nbytes
            dst = self._dst_node(group_id, 0, repaired[0])
            ready = 0.0
            for c in sources:
                src_node = self.store.node_of((group_id, 0, c))
                ready = max(
                    ready,
                    sim.transfer(
                        Transfer(
                            src_node,
                            dst,
                            block_bytes,
                            max(repaired_ready.get(c, 0.0), self.not_before),
                            priority=self.priority,
                            ctx=ctx,
                        )
                    ),
                )
            rep = self._xor(keys) if kind == "local" else self._product(coeffs, keys)
            for i, c in enumerate(repaired):
                with host.span("repair.put", rep[i].nbytes):
                    self.store.put_block((group_id, 0, c), rep[i])
                repaired_ready[c] = ready
                if self.on_block_repaired is not None:
                    self.on_block_repaired((group_id, 0, c))
                # redistribution of extra regenerated blocks to their homes
                if i > 0:
                    home = self.store.node_of((group_id, 0, c))
                    sim.transfer(
                        Transfer(
                            dst, home, rep[i].nbytes, ready,
                            priority=self.priority, ctx=ctx,
                        )
                    )
            report.blocks_fetched += len(sources)
            report.bytes_fetched += len(sources) * block_bytes
            report.blocks_repaired += len(repaired)
            descs.append(f"{'L' if kind == 'local' else 'G'}x{len(repaired)}")
        report.network_time = self._net_time(sim)
        report.compute_time = self._timed
        report.schedule = ",".join(descs)
        self._emit_group_span(group_id, sim, report)
        return report

    # -- HDFS-RAID modes --------------------------------------------------------
    def _fix_raid(self, group_id: str, rows: int, cols: int, optimized: bool) -> RepairReport:
        """Row-by-row (per-stripe) RS repair, no cross-object parity use."""
        report = RepairReport(mode="hdfs_raid_opt" if optimized else "hdfs_raid")
        sim = self._sim()
        sched_desc = []
        for r in range(rows):
            failed = [c for c in range(cols) if not self.store.available((group_id, r, c))]
            if not failed:
                continue
            if len(failed) > self.code.m:
                report.recovered = False
                continue
            if optimized:
                batches = [failed]  # Opt2: all failures of the stripe at once
            else:
                batches = [[c] for c in failed]  # classic: discovered one by one
            repaired_cells: set[int] = set()
            for batch in batches:
                avail = [
                    c
                    for c in range(cols)
                    if c not in failed or c in repaired_cells
                ]
                if optimized:
                    fetch_cols = avail[: self.code.k]  # Opt1: exactly k
                else:
                    fetch_cols = avail  # classic: ALL remaining blocks
                block_bytes = self.store.get((group_id, r, fetch_cols[0])).nbytes
                dst = self._dst_node(group_id, r, batch[0])
                ready = 0.0
                for c in fetch_cols:
                    src = self.store.node_of((group_id, r, c))
                    ready = max(
                        ready,
                        sim.transfer(
                            Transfer(
                                src,
                                dst,
                                block_bytes,
                                self.not_before,
                                priority=self.priority,
                            )
                        ),
                    )
                # the decode reads the first k blocks fetched; the classic
                # mode fetches every survivor all the same
                row_ids, coeffs = self.code.horizontal.repair_matrix(
                    np.asarray(fetch_cols[: self.code.k]), np.asarray(batch)
                )
                rep = self._product(coeffs, [(group_id, r, int(c)) for c in row_ids])
                for i, c in enumerate(batch):
                    with host.span("repair.put", rep[i].nbytes):
                        self.store.put_block((group_id, r, c), rep[i])
                    repaired_cells.add(c)
                    if self.on_block_repaired is not None:
                        self.on_block_repaired((group_id, r, c))
                report.blocks_fetched += len(fetch_cols)
                report.bytes_fetched += len(fetch_cols) * block_bytes
                report.blocks_repaired += len(batch)
                sched_desc.append(f"H{r}x{len(batch)}")
        report.network_time = self._net_time(sim)
        report.compute_time = self._timed
        report.schedule = ",".join(sched_desc)
        return report

    # -- CORE mode ---------------------------------------------------------------
    def _fix_core(self, group_id: str, rows: int, cols: int) -> RepairReport:
        report = RepairReport(mode="core")
        fm = self.store.failure_matrix(group_id, rows, cols)
        if not fm.any():
            return report
        sim = self._sim()
        descs = []
        block_ready: dict[tuple[int, int], float] = {}
        for cluster in independent_clusters(fm):
            if not is_recoverable(self.code, cluster):
                report.recovered = False  # partial recovery: other clusters proceed
                continue
            sched = SCHEDULERS[self.scheduler](self.code, cluster)
            assert sched is not None
            descs.append(sched.describe())
            for step in sched.steps:
                self._execute_step(group_id, step, sim, block_ready, report)
        report.network_time = self._net_time(sim)
        report.compute_time = self._timed
        report.schedule = ";".join(descs)
        self._emit_group_span(group_id, sim, report)
        return report

    def _emit_group_span(
        self, group_id: str, sim: NetSimulator, report: RepairReport
    ) -> None:
        ctx = self._obs_ctx()
        if ctx is None or report.blocks_repaired == 0:
            return
        tid, pid = ctx
        end = max(
            sim.class_makespan.get(self.priority, self.not_before),
            self.not_before,
        )
        self.tracer.span(
            "repair.group",
            self.not_before,
            end,
            tid,
            pid,
            track=("repair", "repair"),
            group=group_id,
            mode=report.mode,
            blocks_repaired=report.blocks_repaired,
            bytes_fetched=report.bytes_fetched,
            recovered=report.recovered,
        )

    def _execute_step(
        self,
        group_id: str,
        step: RepairStep,
        sim: NetSimulator,
        block_ready: dict,
        report: RepairReport,
    ) -> None:
        srcs = [(r, c) for (r, c) in step.sources]
        block_bytes = self.store.get((group_id, *srcs[0])).nbytes
        dst_cell = step.repairs[0]
        dst = self._dst_node(group_id, *dst_cell)
        ctx = self._obs_ctx()
        ready = 0.0
        for r, c in srcs:
            src_node = self.store.node_of((group_id, r, c))
            ready = max(
                ready,
                sim.transfer(
                    Transfer(
                        src_node,
                        dst,
                        block_bytes,
                        max(block_ready.get((r, c), 0.0), self.not_before),
                        priority=self.priority,
                        ctx=ctx,
                    )
                ),
            )
        if ctx is not None:
            self.tracer.span(
                "repair.fetch",
                self.not_before,
                ready,
                ctx[0],
                ctx[1],
                track=("repair", "repair"),
                kind=step.kind,
                blocks=len(srcs),
            )
        if step.kind == "V":
            rep = self._xor([(group_id, r, c) for r, c in srcs])
        else:
            row_ids, coeffs = self.code.horizontal.repair_matrix(
                np.asarray([c for (_, c) in srcs]),
                np.asarray([c for (_, c) in step.repairs]),
            )
            rep = self._product(coeffs, [(group_id, step.index, int(c)) for c in row_ids])
        for i, cell in enumerate(step.repairs):
            with host.span("repair.put", rep[i].nbytes):
                self.store.put_block((group_id, cell[0], cell[1]), rep[i])
            block_ready[cell] = ready
            if self.on_block_repaired is not None:
                self.on_block_repaired((group_id, cell[0], cell[1]))
            # redistribution of extra regenerated blocks to their new homes
            if i > 0:
                home = self.store.node_of((group_id, cell[0], cell[1]))
                sim.transfer(
                    Transfer(
                        dst, home, rep[i].nbytes, ready,
                        priority=self.priority, ctx=ctx,
                    )
                )
        report.blocks_fetched += len(srcs)
        report.bytes_fetched += len(srcs) * block_bytes
        report.blocks_repaired += len(step.repairs)

    # -- degraded read -------------------------------------------------------------
    def degraded_read(self, group_id: str, row: int) -> tuple[np.ndarray, RepairReport]:
        """Read object ``row`` (k data blocks) tolerating missing blocks,
        without writing repairs back (a pure degraded read)."""
        report = RepairReport(mode=f"{self.mode}-read")
        k, cols = self.code.k, self.code.n
        sim = NetSimulator(self.profile)
        out = []
        missing = [c for c in range(k) if not self.store.available((group_id, row, c))]
        avail_row = [c for c in range(cols) if self.store.available((group_id, row, c))]
        use_row_decode = False
        if self.mode != "core":
            use_row_decode = bool(missing)
        else:
            for c in missing:
                col_ok = all(
                    self.store.available((group_id, r, c))
                    for r in range(self.code.rows)
                    if r != row
                )
                if not col_ok:
                    use_row_decode = True
                    break
        if not missing:
            for c in range(k):
                b = self.store.get((group_id, row, c))
                sim.transfer(Transfer(self.store.node_of((group_id, row, c)), -1, b.nbytes))
                out.append(b)
                report.blocks_fetched += 1
                report.bytes_fetched += b.nbytes
            data = np.stack(out)
        elif use_row_decode:
            if len(avail_row) < k:
                raise UnrecoverableError(f"row {row} of {group_id} lost")
            fetch = avail_row[:k]
            block_bytes = self.store.get((group_id, row, fetch[0])).nbytes
            for c in fetch:
                sim.transfer(
                    Transfer(self.store.node_of((group_id, row, c)), -1, block_bytes)
                )
            report.blocks_fetched += len(fetch)
            report.bytes_fetched += len(fetch) * block_bytes
            row_ids, inverse = _decode_matrix(self.code, tuple(fetch))
            data = self._product(inverse, [(group_id, row, int(c)) for c in row_ids])
        else:
            got: dict[int, np.ndarray] = {}
            for c in range(k):
                if c not in missing:
                    b = self.store.get((group_id, row, c))
                    sim.transfer(Transfer(self.store.node_of((group_id, row, c)), -1, b.nbytes))
                    got[c] = b
                    report.blocks_fetched += 1
                    report.bytes_fetched += b.nbytes
            for c in missing:
                srcs = [r for r in range(self.code.rows) if r != row]
                block_bytes = self.store.get((group_id, srcs[0], c)).nbytes
                for r in srcs:
                    sim.transfer(
                        Transfer(self.store.node_of((group_id, r, c)), -1, block_bytes)
                    )
                report.blocks_fetched += len(srcs)
                report.bytes_fetched += len(srcs) * block_bytes
                got[c] = self._xor([(group_id, r, c) for r in srcs])[0]
            data = np.stack([got[c] for c in range(k)])
        report.network_time = sim.makespan
        report.compute_time = self._timed
        return data, report

    # -- helpers ----------------------------------------------------------------
    def _dst_node(self, group_id: str, r: int, c: int) -> int:
        used = {
            self.store.placement[key]
            for key in self.store.placement
            if key[0] == group_id and self.store.available(key)
        }
        for node in self.store.alive_nodes():
            if node not in used:
                return node
        return self.store.alive_nodes()[0]


# -- codec math (shared, cached) ------------------------------------------------


class _Staging:
    """A host buffer reused from one repair step to the next, grown only
    when a step needs more; pinned when the codec runs on the card."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.buf: torch.Tensor | None = None

    def take(self, nbytes: int, least: int = 0) -> torch.Tensor:
        """The first ``nbytes`` of the buffer, made at ``max(nbytes,
        least)`` bytes where it is missing or too small."""
        if self.buf is None or self.buf.numel() < nbytes:
            self.buf = None  # the smaller buffer goes before the larger is made
            self.buf = torch.empty(
                max(nbytes, least), dtype=torch.uint8, pin_memory=self.pinned
            )
        return self.buf[:nbytes]


def _xor_rows(blocks: torch.Tensor) -> torch.Tensor:
    return gf256.xor_reduce(blocks, axis=0)[None]


def _gf256_product(coeffs: np.ndarray, sources: torch.Tensor) -> torch.Tensor:
    """The GF(256) repair product coeffs (M, K) @ sources (K, q): K5
    (``kernels.ops.gf256_matmul``) for sources on the card, the plain
    ``coding.gf256.matmul`` for sources on the CPU; the same bytes."""
    if sources.device.type == "cuda":
        return kernel_ops.gf256_matmul(coeffs, sources)
    return gf256.matmul(coeffs, sources)


_DECODE_CACHE: dict = {}


def _decode_matrix(code: CoreCode, cols: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """(row order, inverse) of the row decode from the columns ``cols``:
    message blocks (k, q) = inverse @ those columns' blocks in that row
    order (cached per (n, k, columns))."""
    key = (code.n, code.k, cols)
    if key not in _DECODE_CACHE:
        _DECODE_CACHE[key] = code.horizontal.decode_matrix(np.asarray(cols))
    return _DECODE_CACHE[key]
