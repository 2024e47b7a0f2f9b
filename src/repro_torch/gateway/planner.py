"""Per-request degraded-read planning (the paper's Table 1 cost model,
applied online).

A GET for object ``row`` of a group needs its k data blocks. For each
missing data block the gateway can reconstruct either

  * vertically  — XOR of the t surviving blocks of its COLUMN (needs the
    whole column minus this row intact): t source blocks, and
  * horizontally — RS decode over k surviving blocks of its ROW: k
    source blocks, but ONE decode covers every missing block of the row.

The planner sees the live failure set and picks the cheapest total plan:
all-vertical costs t per missing block; one horizontal decode costs k
for any number of missing blocks; if any column is broken the horizontal
path is forced. Plans carry host-side coefficient matrices so the
coalescer can batch decodes across concurrent requests.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.coding import lrc as lrc_mod
from repro_torch.coding import rs
from repro_torch.core.product_code import CoreCode, CoreCodec
from repro_torch.storage.blockstore import BlockKey, BlockStore


class UnreadableObjectError(RuntimeError):
    """Neither the vertical nor the horizontal path can serve the read."""


@dataclass(frozen=True)
class DecodeOp:
    """One reconstruction: targets = coeffs @ sources (GF(256)), or a
    plain XOR over sources when kind == "V" (coeffs is None)."""

    kind: str  # "V" | "H"
    group_id: str
    row: int
    targets: tuple[int, ...]  # data columns this op regenerates
    sources: tuple[BlockKey, ...]
    coeffs: np.ndarray | None  # (len(targets), len(sources)) for "H"

    @property
    def shape_key(self) -> tuple:
        """Decode-shape bucket: ops sharing this key can share one
        batched kernel launch."""
        return (self.kind, len(self.targets), len(self.sources))


@dataclass(frozen=True)
class ReadPlan:
    group_id: str
    row: int
    direct: tuple[BlockKey, ...]  # available data blocks, fetched as-is
    decodes: tuple[DecodeOp, ...]
    # Clock at which the plan was made against the live failure set; the
    # pipelined gateway uses it as the fetch stage's earliest start (a
    # plan is only valid from the moment it was planned).
    planned_at: float = 0.0

    @property
    def degraded(self) -> bool:
        return bool(self.decodes)

    @property
    def source_keys(self) -> tuple[BlockKey, ...]:
        """All distinct blocks the plan touches (direct + decode inputs)."""
        seen: dict[BlockKey, None] = dict.fromkeys(self.direct)
        for op in self.decodes:
            seen.update(dict.fromkeys(op.sources))
        return tuple(seen)

    @property
    def reconstruction_blocks(self) -> int:
        """Source blocks consumed by reconstruction — the paper's Table 1
        traffic figure (t per vertical repair, k per horizontal decode)."""
        return sum(len(op.sources) for op in self.decodes)


class CodeFamily:
    """A code family as a per-namespace property (ROADMAP bake-off item).

    Everything the serving and repair planes need to know about an
    erasure code lives behind this interface, so RS, CORE, and LRC all
    run through the SAME gateway, tenant workload, and fault traces:

      * geometry — how many block rows a group matrix has, how many
        objects pack into one group, and the storage stretch;
      * the encode path (``encode_group``);
      * degraded-read candidate enumeration (``candidates`` /
        ``recovery_ops``) producing coalescer-ready :class:`DecodeOp`
        uops ("V" = plain XOR over any source count, "H" = GF(256)
        matmul with a host-side coefficient plane);
      * the repair cost surface (``single_repair_cost`` /
        ``avg_repair_cost`` in source blocks per repaired block, and
        ``repair_plan`` for the row-coded families) that
        :class:`repro_torch.storage.repair.BlockFixer` and the bake-off bench
        price against;
      * ``tolerance`` — the number of concurrent node failures the
        family survives under anti-colocated placement, which bounds
        scenario admission (``ScenarioConfig.max_concurrent_failures``).

    ``available(key) -> bool`` arguments are the planner's liveness
    oracle (store OR cache), so families never touch the store directly.
    """

    name = "?"

    # -- geometry -----------------------------------------------------------
    rows: int
    n: int
    k: int
    objects_per_group: int

    @property
    def tolerance(self) -> int:
        """Concurrent node failures always survivable (anti-colocated)."""
        raise NotImplementedError

    @property
    def storage_overhead(self) -> float:
        """Stored bytes per data byte (the paper's stretch factor)."""
        raise NotImplementedError

    @property
    def degraded_fetch_blocks(self) -> int:
        """Pessimistic distinct-block count of one degraded GET — the
        admission controller's foreground-pressure unit."""
        raise NotImplementedError

    def encode_group(self, objects):
        """objects (objects_per_group, k, q) -> group matrix (rows, n, q)."""
        raise NotImplementedError

    def group_recoverable(self, available) -> bool:
        """Whole-group durability check for the audit plane.

        ``available(key) -> bool``; keys range over (row, col) pairs of
        one group with group_id "" (the oracle closes over the gid)."""
        raise NotImplementedError

    # -- degraded-read candidate enumeration --------------------------------
    def candidates(
        self, available, group_id: str, row: int, at: float = 0.0
    ) -> tuple[ReadPlan, ...]:
        raise NotImplementedError

    def recovery_ops(
        self, available, group_id: str, row: int, col: int
    ) -> tuple[DecodeOp, ...]:
        raise NotImplementedError

    # -- repair cost surface ------------------------------------------------
    def single_repair_cost(self, col: int) -> int:
        """Source blocks to regenerate one lost block in column ``col``."""
        raise NotImplementedError

    @property
    def avg_repair_cost(self) -> float:
        """Mean single-block repair traffic over all n columns."""
        return sum(self.single_repair_cost(c) for c in range(self.n)) / self.n

    def repair_plan(
        self, failed: set[int]
    ) -> list[tuple[str, list[int], list[int]]] | None:
        """Row-coded families (rows == 1): ordered steps
        ``(kind, sources, repaired)`` with kind 'local' (XOR) or 'global'
        (GF decode), or None when unrecoverable. CORE repairs through the
        two-dimensional scheduler in storage/repair.py instead."""
        raise NotImplementedError(f"{self.name} repairs via BlockFixer schedulers")


class CoreFamily(CodeFamily):
    """The (n, k, t) CORE product code — the default namespace family.

    Candidate enumeration is the paper's Table 1 applied online: t
    sources per missing block vertically, k sources for the whole row
    horizontally, vertical preferred on ties (pure XOR vs GF decode)."""

    name = "core"

    def __init__(self, code: CoreCode, device: str | None = None):
        self.code = code
        self.rows = code.rows
        self.n = code.n
        self.k = code.k
        self.objects_per_group = code.t
        self._codec = CoreCodec(code, device=device)

    @property
    def tolerance(self) -> int:
        # Any <= m erasures leave every row with >= k survivors, so the
        # horizontal code alone guarantees recovery; vertical XOR only
        # ever makes repairs cheaper.
        return self.code.m

    @property
    def storage_overhead(self) -> float:
        return self.code.stretch

    @property
    def degraded_fetch_blocks(self) -> int:
        return self.code.k + self.code.t

    def encode_group(self, objects):
        return self._codec.encode(objects)

    def group_recoverable(self, available) -> bool:
        # Row-wise horizontal sufficiency matches ``tolerance``: the
        # fixer's 2D scheduler can always do at least this well.
        return all(
            sum(1 for c in range(self.n) if available((r, c))) >= self.k
            for r in range(self.rows)
        )

    def candidates(
        self, available, group_id: str, row: int, at: float = 0.0
    ) -> tuple[ReadPlan, ...]:
        code = self.code
        k, n = code.k, code.n
        avail_data = [c for c in range(k) if available((group_id, row, c))]
        missing = [c for c in range(k) if c not in avail_data]
        direct = tuple((group_id, row, c) for c in avail_data)
        if not missing:
            return (ReadPlan(group_id, row, direct, (), planned_at=at),)

        vertical_ok = all(
            self._column_intact(available, group_id, row, c) for c in missing
        )
        avail_row = [c for c in range(n) if available((group_id, row, c))]
        horizontal_ok = len(avail_row) >= k

        vertical = (
            ReadPlan(
                group_id,
                row,
                direct,
                tuple(self._vertical_op(group_id, row, c) for c in missing),
                planned_at=at,
            )
            if vertical_ok
            else None
        )
        horizontal = (
            ReadPlan(
                group_id,
                row,
                direct,
                (self._horizontal_op(group_id, row, avail_row, missing),),
                planned_at=at,
            )
            if horizontal_ok
            else None
        )
        # Table 1: vertical = t reads per block, horizontal = k reads for
        # the whole row. Prefer vertical on ties (pure XOR vs GF decode).
        v_cost = code.t * len(missing)
        if vertical is not None and horizontal is not None:
            ordered = (
                (vertical, horizontal) if v_cost <= k else (horizontal, vertical)
            )
            return ordered
        if vertical is not None:
            return (vertical,)
        if horizontal is not None:
            return (horizontal,)
        raise UnreadableObjectError(
            f"object ({group_id}, row {row}): columns {missing} broken and "
            f"only {len(avail_row)} < k={k} row blocks survive"
        )

    def recovery_ops(
        self, available, group_id: str, row: int, col: int
    ) -> tuple[DecodeOp, ...]:
        ops = []
        if self._column_intact(available, group_id, row, col):
            ops.append(self._vertical_op(group_id, row, col))
        avail_row = [
            c
            for c in range(self.code.n)
            if c != col and available((group_id, row, c))
        ]
        if len(avail_row) >= self.code.k:
            ops.append(self._horizontal_op(group_id, row, avail_row, [col]))
        return tuple(ops)

    def single_repair_cost(self, col: int) -> int:
        return self.code.t  # vertical XOR of the column's survivors

    def repair_plan(self, failed):
        raise NotImplementedError("core repairs via BlockFixer 2D schedulers")

    # -- helpers ------------------------------------------------------------
    def _column_intact(self, available, group_id: str, row: int, col: int) -> bool:
        return all(
            available((group_id, r, col))
            for r in range(self.code.rows)
            if r != row
        )

    def _vertical_op(self, group_id: str, row: int, col: int) -> DecodeOp:
        sources = tuple(
            (group_id, r, col) for r in range(self.code.rows) if r != row
        )
        return DecodeOp("V", group_id, row, (col,), sources, None)

    def _horizontal_op(
        self, group_id: str, row: int, avail_row: list[int], missing: list[int]
    ) -> DecodeOp:
        # Prefer the available data columns as sources — the GET fetches
        # them anyway, so total distinct blocks stays at k (Table 1).
        preferred = [c for c in avail_row if c < self.code.k] + [
            c for c in avail_row if c >= self.code.k
        ]
        row_ids, coeffs = self.code.horizontal.repair_matrix(
            np.asarray(preferred), np.asarray(missing)
        )
        sources = tuple((group_id, row, int(c)) for c in row_ids)
        return DecodeOp(
            "H", group_id, row, tuple(missing), sources, np.asarray(coeffs)
        )


class RowCodeFamily(CodeFamily):
    """Shared machinery for the single-row (rows == 1) families: one
    object per group stored as one (n,) codeword row. Degraded reads are
    one "H" decode over >= k survivors; subclasses add locality."""

    rows = 1
    objects_per_group = 1

    def __init__(self, code, device: str | None = None):
        self.code = code
        self.n = code.n
        self.k = code.k
        self.device = device

    @property
    def storage_overhead(self) -> float:
        return self.n / self.k

    @property
    def degraded_fetch_blocks(self) -> int:
        return self.k

    def encode_group(self, objects):
        return self.code.encode(objects, self.device)  # (1, k, q) -> (1, n, q)

    def group_recoverable(self, available) -> bool:
        avail = [c for c in range(self.n) if available((0, c))]
        return self.code.decodable(np.asarray(avail))

    def candidates(
        self, available, group_id: str, row: int, at: float = 0.0
    ) -> tuple[ReadPlan, ...]:
        avail_data = [c for c in range(self.k) if available((group_id, row, c))]
        missing = [c for c in range(self.k) if c not in avail_data]
        direct = tuple((group_id, row, c) for c in avail_data)
        if not missing:
            return (ReadPlan(group_id, row, direct, (), planned_at=at),)
        plans = self._degraded_plans(available, group_id, row, direct, missing, at)
        if not plans:
            raise UnreadableObjectError(
                f"object ({group_id}, row {row}): columns {missing} broken "
                f"and fewer than k={self.k} row blocks survive"
            )
        return tuple(plans)

    def recovery_ops(
        self, available, group_id: str, row: int, col: int
    ) -> tuple[DecodeOp, ...]:
        ops = []
        local = self._local_op(available, group_id, row, col)
        if local is not None:
            ops.append(local)
        avail_row = [
            c
            for c in range(self.n)
            if c != col and available((group_id, row, c))
        ]
        if self.code.decodable(np.asarray(avail_row)):
            ops.append(self._global_op(group_id, row, avail_row, [col]))
        return tuple(ops)

    def single_repair_cost(self, col: int) -> int:
        return self.k

    def repair_plan(self, failed):
        failed = sorted(set(failed))
        available = [c for c in range((self.n)) if c not in failed]
        if not self.code.decodable(np.asarray(available)):
            return None
        row_ids, _ = self.code.repair_matrix(
            np.asarray(available), np.asarray(failed)
        )
        return [("global", [int(r) for r in row_ids], list(failed))]

    # -- hooks --------------------------------------------------------------
    def _degraded_plans(self, available, group_id, row, direct, missing, at):
        plans = []
        avail_row = [c for c in range(self.n) if available((group_id, row, c))]
        if len(avail_row) >= self.k and self.code.decodable(np.asarray(avail_row)):
            plans.append(
                ReadPlan(
                    group_id,
                    row,
                    direct,
                    (self._global_op(group_id, row, avail_row, missing),),
                    planned_at=at,
                )
            )
        return plans

    def _local_op(self, available, group_id, row, col) -> DecodeOp | None:
        return None  # plain MDS codes have no locality

    def _global_op(
        self, group_id: str, row: int, avail_row: list[int], missing: list[int]
    ) -> DecodeOp:
        # Prefer data columns as sources, same rationale as CORE's
        # horizontal op: the GET fetches them anyway.
        preferred = [c for c in avail_row if c < self.k] + [
            c for c in avail_row if c >= self.k
        ]
        row_ids, coeffs = self.code.repair_matrix(
            np.asarray(preferred), np.asarray(missing)
        )
        sources = tuple((group_id, row, int(c)) for c in row_ids)
        return DecodeOp(
            "H", group_id, row, tuple(missing), sources, np.asarray(coeffs)
        )


class RSFamily(RowCodeFamily):
    """Plain (n, k) Reed-Solomon — the paper's "traditional erasure
    code" baseline: every repair and every degraded read costs k source
    blocks, storage stretch n/k."""

    name = "rs"

    def __init__(self, n: int, k: int, device: str | None = None):
        super().__init__(rs.make_rs(n, k), device)

    @property
    def tolerance(self) -> int:
        return self.n - self.k  # MDS


class LRCFamily(RowCodeFamily):
    """(n, k) Azure-style Local Reconstruction Code (coding/lrc.py).

    Single-block loss inside a local group repairs from the k/2
    surviving group members by plain XOR (a "V" uop — the coalescer's
    XOR path takes any source count); multi-loss patterns fall back to
    one global "H" decode over >= k independent survivors."""

    name = "lrc"

    def __init__(self, n: int, k: int, device: str | None = None):
        super().__init__(lrc_mod.make_lrc(n, k), device)

    @property
    def tolerance(self) -> int:
        # d = n - k: any n-k-1 erasures decode (many n-k patterns do
        # too, but admission bounds on the guarantee).
        return self.n - self.k - 1

    def single_repair_cost(self, col: int) -> int:
        return self.k // 2 if self.code.local_group(col) is not None else self.k

    @property
    def avg_repair_cost(self) -> float:
        return lrc_mod.avg_single_repair_cost(self.n, self.k)

    def repair_plan(self, failed):
        return self.code.repair_plan(set(failed))

    def _degraded_plans(self, available, group_id, row, direct, missing, at):
        plans = []
        local_ops = []
        for col in missing:
            op = self._local_op(available, group_id, row, col)
            if op is None:
                break
            local_ops.append(op)
        if len(local_ops) == len(missing):
            plans.append(
                ReadPlan(group_id, row, direct, tuple(local_ops), planned_at=at)
            )
        plans.extend(
            super()._degraded_plans(available, group_id, row, direct, missing, at)
        )
        # Order by traffic: local XOR costs k/2 per missing block, the
        # global decode k for the whole row. Prefer local on ties.
        plans.sort(key=lambda p: p.reconstruction_blocks)
        return plans

    def _local_op(self, available, group_id, row, col) -> DecodeOp | None:
        grp = self.code.local_group(col)
        if grp is None:
            return None
        sources = [g for g in grp if g != col]
        if not all(available((group_id, row, g)) for g in sources):
            return None
        return DecodeOp(
            "V",
            group_id,
            row,
            (col,),
            tuple((group_id, row, g) for g in sources),
            None,
        )


FAMILY_NAMES = ("core", "rs", "lrc")


def make_family(
    code: CoreCode, name: str = "core", device: str | None = None
) -> CodeFamily:
    """Build the named family on the shared (n, k) geometry of ``code``.

    RS and LRC derive (n, k) from the CORE parameters so all three
    families stripe the same row shape — the bake-off comparison and the
    GatewayConfig plumbing both key off one CoreCode. ``device`` is where
    the family's encode runs (None: the card)."""
    if name == "core":
        return CoreFamily(code, device)
    if name == "rs":
        return RSFamily(code.n, code.k, device)
    if name == "lrc":
        return LRCFamily(code.n, code.k, device)
    raise ValueError(f"unknown code family {name!r} (want one of {FAMILY_NAMES})")


class DegradedReadPlanner:
    def __init__(
        self,
        store: BlockStore,
        code: CoreCode,
        available_fn=None,
        family: CodeFamily | None = None,
    ):
        """``available_fn(key) -> bool`` overrides raw store availability —
        the gateway passes "in the store OR in the block cache" so cached
        reconstructions short-circuit replanning. ``family`` selects the
        code family (default: the CORE product code on ``code``)."""
        self.store = store
        self.code = code
        self.family = family if family is not None else CoreFamily(code)
        self._available = available_fn if available_fn is not None else store.available

    def plan(self, group_id: str, row: int, at: float = 0.0) -> ReadPlan:
        """The cost-model-cheapest viable plan (first candidate)."""
        return self.candidates(group_id, row, at=at)[0]

    def candidates(
        self, group_id: str, row: int, at: float = 0.0
    ) -> tuple[ReadPlan, ...]:
        """Every viable plan for this read against the live failure set,
        family-cost-cheapest first (the paper's Table 1 for CORE). A
        healthy object has exactly one (all direct). The gateway's SLO
        admission controller re-ranks these by *estimated completion
        time* when a request is about to bust its tenant's latency
        target — under a backlogged decode engine the byte-cheapest plan
        is not always the latency-cheapest one."""
        return self.family.candidates(self._available, group_id, row, at=at)

    def recovery_ops(
        self, group_id: str, row: int, col: int
    ) -> tuple[DecodeOp, ...]:
        """Every viable single-block reconstruction of ONE data column,
        cheapest first — the hedged-fetch alternate paths: when the
        direct fetch of (group_id, row, col) is stuck behind a fail-slow
        source, the gateway races it against one of these instead of
        waiting. The gateway picks among them by PLACEMENT: a
        reconstruction whose sources share the stuck node loses the
        race, so the byte-cheapest op is not always the winner."""
        return self.family.recovery_ops(self._available, group_id, row, col)

    def recovery_op(self, group_id: str, row: int, col: int) -> DecodeOp | None:
        """Cheapest single-block reconstruction (first of recovery_ops)."""
        ops = self.recovery_ops(group_id, row, col)
        return ops[0] if ops else None
