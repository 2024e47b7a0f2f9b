"""Simulated distributed block store (the HDFS analogue).

Blocks are addressed by (group_id, row, col) — a cell of a CORE matrix
(for plain RS groups, row is always 0). Placement is anti-colocating like
HDFS-RAID's RaidNode policy: all blocks of a group land on distinct
nodes, so a node failure costs each group at most one block — the failure
model under which the paper's per-column/-row analysis holds.

Rack awareness (XORing Elephants, 1301.3791): when ``nodes_per_rack``
is set, nodes are partitioned into failure domains of that size and
placement lifts the anti-colocation invariant from nodes to racks — no
two blocks of the same row OR column share a rack, so a whole-rack
failure (ToR switch, PDU) still costs each stripe and each vertical
group at most one block. With ``nodes_per_rack=None`` every node is its
own rack and the classic layout is byte-identical to before.

Data lives in host numpy (this is the "disk"); codec math runs in torch.

Integrity plane: every stored block carries a crc32 digest computed at
PUT time (``checksums``), read straight from the array's buffer with no
copy, by the carry-less-multiply fold of ``crc32.py`` where the host
runs it, else by zlib (the integer is zlib's either way). ``verify``
recomputes a block's digest against the stored one, and ``verify_many``
does so for a batch of blocks on host threads — a mismatch means
SILENT corruption (a bit flip or torn write injected by
``corrupt_block`` leaves the stored digest stale on purpose, exactly
like a disk returning bad bytes under a good extent map). The gateway
reclassifies a verify failure as an erasure: ``quarantine`` removes the
bytes from the readable set while keeping the placement and the
reference digest, so repair re-places the block in situ and the repaired
bytes can be checked against the original digest.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs import host
from repro_torch.storage import crc32

BlockKey = tuple[str, int, int]  # (group_id, row, col)

# A batch of fewer bytes than this is hashed on the calling thread: at
# the fold's 5.5-9 GB/s a thread (zlib's 1.8-2.7), 1 MiB is 0.1-0.2 ms
# of crc32, more than handing it to the pool and waiting for it cost.
POOL_MIN_BYTES = 1 << 20

_pool: ThreadPoolExecutor | None = None  # the crc32 workers, made on first use


def _drop_pool() -> None:
    """A forked child inherits the pool's bookkeeping but not its threads."""
    global _pool
    _pool = None


os.register_at_fork(after_in_child=_drop_pool)


def _cpus() -> int:
    """CPUs this process may run on."""
    return len(os.sched_getaffinity(0))


def _workers() -> ThreadPoolExecutor:
    """The module's crc32 pool, one thread per CPU at most."""
    global _pool
    if _pool is None:
        _pool = ThreadPoolExecutor(_cpus(), thread_name_prefix="crc32")
    return _pool


def _as_bytes(data) -> np.ndarray:
    """``data``'s bytes in C order as a flat uint8 array: a view of its
    own buffer where that is C-contiguous, else of a contiguous copy."""
    a = np.ascontiguousarray(data)
    return a.reshape(-1).view(np.uint8)


def _count(views: list[np.ndarray], fn) -> None:
    """Count the bytes ``views`` hash, ``host_crc32_bytes{impl=fold|zlib}``."""
    folded = sum(v.nbytes for v in views if crc32.folds(v, fn))
    rest = sum(v.nbytes for v in views) - folded
    if folded:
        host.count("host_crc32_bytes", folded, impl="fold")
    if rest:
        host.count("host_crc32_bytes", rest, impl="zlib")


def _crc32_all(views: list[np.ndarray], fn) -> list[int]:
    return [crc32.crc32(v, fn) for v in views]  # ctypes, and zlib above 5 KiB, release the GIL


def crc32_many(arrays: list) -> list[int]:
    """``BlockStore.digest`` of each of ``arrays``, in order, by the fold
    where the host runs it, else by zlib. The crc32s run on
    ``min(CPUs, len(arrays))`` pool threads at most, one contiguous share
    of the list each, unless there is one CPU or one array, or the batch
    holds fewer than ``POOL_MIN_BYTES``; then on the calling thread, which
    also builds the fold's library at first use."""
    views = [_as_bytes(a) for a in arrays]
    fn = crc32.fold()
    _count(views, fn)
    width = min(_cpus(), len(views))
    if width <= 1 or sum(v.nbytes for v in views) < POOL_MIN_BYTES:
        host.count("host_verify_blocks", len(views), path="inline")
        host.count("host_verify_workers", 1, span=host.innermost())
        return _crc32_all(views, fn)
    bounds = [len(views) * i // width for i in range(width + 1)]
    shares = [views[lo:hi] for lo, hi in zip(bounds, bounds[1:])]
    host.count("host_verify_blocks", len(views), path="pooled")
    host.count("host_verify_workers", width, span=host.innermost())
    hashed = _workers().map(_crc32_all, shares, [fn] * len(shares))
    return [crc for share in hashed for crc in share]


class PlacementError(RuntimeError):
    pass


@dataclass
class BlockStore:
    num_nodes: int
    nodes_per_rack: int | None = None
    blocks: dict[BlockKey, np.ndarray] = field(default_factory=dict)
    placement: dict[BlockKey, int] = field(default_factory=dict)
    failed_nodes: set[int] = field(default_factory=set)
    checksums: dict[BlockKey, int] = field(default_factory=dict)
    _group_counter: int = 0

    # -- failure domains -------------------------------------------------------
    def rack_of(self, node: int) -> int:
        """Failure-domain id of ``node``. With no rack map configured,
        every node is its own rack (node-level anti-colocation only)."""
        if self.nodes_per_rack is None:
            return int(node)
        return int(node) // self.nodes_per_rack

    # -- integrity -------------------------------------------------------------
    @staticmethod
    def digest(data: np.ndarray) -> int:
        """zlib's crc32 of a block's bytes in C order, hashed in place
        (equal to ``zlib.crc32(np.asarray(data).tobytes())``): by the
        carry-less-multiply fold of ``crc32.py`` from its
        ``FOLD_MIN_BYTES`` up where the host runs it, else by zlib."""
        view = _as_bytes(data)
        fn = crc32.fold()
        _count([view], fn)
        return crc32.crc32(view, fn)

    # -- placement -----------------------------------------------------------
    def _place_group(self, group_id: str, rows: int, cols: int) -> None:
        """Anti-colocated placement of a (rows x cols) group.

        All-distinct when the cluster is big enough; otherwise a
        latin-square-style layout — node(r,c) = (off + c + K*r) mod N —
        guaranteeing no two blocks of the same row OR column share a
        node (one node failure => at most one failure per stripe and
        per vertical group), which is the paper's placement requirement
        for its 20-node clusters."""
        need = rows * cols
        alive = [n for n in range(self.num_nodes) if n not in self.failed_nodes]
        # crc32, not hash(): placement must be stable across processes
        # (PYTHONHASHSEED randomizes str hashes per run)
        salt = zlib.crc32(group_id.encode()) ^ self._group_counter
        offset = salt % len(alive)
        self._group_counter += 1
        if self.nodes_per_rack is not None:
            self._place_group_rack_aware(group_id, rows, cols, alive, salt)
            return
        if need <= len(alive):
            chosen = [alive[(offset + i) % len(alive)] for i in range(need)]
            i = 0
            for r in range(rows):
                for c in range(cols):
                    self.placement[(group_id, r, c)] = chosen[i]
                    i += 1
            return
        n = len(alive)
        if max(rows, cols) > n:
            raise PlacementError(
                f"group {group_id} needs >= {max(rows, cols)} nodes for "
                f"row/column anti-colocation, {n} alive"
            )
        k_step = next(
            (k for k in range(1, n) if all((k * d) % n for d in range(1, rows))),
            None,
        )
        if k_step is None:
            raise PlacementError(f"no anti-colocating stride for {rows}x{cols} on {n}")
        for r in range(rows):
            for c in range(cols):
                self.placement[(group_id, r, c)] = alive[(offset + c + k_step * r) % n]

    def _place_group_rack_aware(
        self, group_id: str, rows: int, cols: int, alive: list[int], salt: int
    ) -> None:
        """Latin-square layout over RACKS instead of nodes: rack(r, c) =
        racks[(off + c + step*r) mod R]. With R >= cols the racks within
        a row are all distinct, and an anti-colocating stride keeps the
        racks within a column distinct — one whole-rack failure costs
        each stripe and each vertical group at most one block. Within a
        rack, a per-group rotation spreads blocks over the rack's alive
        nodes (distinct nodes whenever capacity allows)."""
        racks: dict[int, list[int]] = {}
        for n in alive:
            racks.setdefault(self.rack_of(n), []).append(n)
        rack_ids = sorted(racks)
        n_racks = len(rack_ids)
        if n_racks < cols:
            raise PlacementError(
                f"group {group_id}: rack-aware placement needs >= {cols} racks "
                f"with alive nodes (one rack per stripe block), {n_racks} available"
            )
        step = next(
            (s for s in range(1, n_racks) if all((s * d) % n_racks for d in range(1, rows))),
            None,
        )
        if step is None:
            raise PlacementError(
                f"no anti-colocating rack stride for {rows}x{cols} over {n_racks} racks"
            )
        off = salt % n_racks
        used: set[int] = set()
        spin: dict[int, int] = {}
        for r in range(rows):
            for c in range(cols):
                rid = rack_ids[(off + c + step * r) % n_racks]
                members = racks[rid]
                start = (salt + spin.get(rid, 0)) % len(members)
                spin[rid] = spin.get(rid, 0) + 1
                node = next(
                    (
                        members[(start + i) % len(members)]
                        for i in range(len(members))
                        if members[(start + i) % len(members)] not in used
                    ),
                    members[start],
                )
                used.add(node)
                self.placement[(group_id, r, c)] = node

    # -- block API ------------------------------------------------------------
    def put_group(self, group_id: str, matrix: np.ndarray) -> None:
        """Store a full (rows, cols, q) group."""
        rows, cols = matrix.shape[:2]
        self._place_group(group_id, rows, cols)
        for r in range(rows):
            for c in range(cols):
                blk = np.asarray(matrix[r, c])
                self.blocks[(group_id, r, c)] = blk
                self.checksums[(group_id, r, c)] = self.digest(blk)

    def put_block(self, key: BlockKey, data: np.ndarray, node: int | None = None) -> None:
        cur = self.placement.get(key)
        if node is not None:
            self.placement[key] = node
        elif cur is None or cur in self.failed_nodes:
            # (re-)place on a fresh alive node not already used by the group
            alive = [n for n in range(self.num_nodes) if n not in self.failed_nodes]
            used = {
                self.placement[k]
                for k in self.placement
                if k[0] == key[0] and self.available(k)
            }
            free = [n for n in alive if n not in used]
            if free:
                if self.nodes_per_rack is not None:
                    # keep the rack invariant on repair write-back: avoid
                    # racks already hosting a live block of this row/col
                    gid, row, col = key
                    bad_racks = {
                        self.rack_of(self.placement[k])
                        for k in self.placement
                        if k[0] == gid
                        and k != key
                        and (k[1] == row or k[2] == col)
                        and self.available(k)
                    }
                    rack_ok = [n for n in free if self.rack_of(n) not in bad_racks]
                    if rack_ok:
                        free = rack_ok
                self.placement[key] = free[0]
            else:
                # dense cluster: every alive node already hosts a group
                # block. Fall back to the weaker-but-essential invariant
                # (the paper's placement requirement): never co-locate
                # with another live block of the same ROW or COLUMN, so
                # one node failure still costs each stripe and each
                # vertical group at most one block.
                gid, row, col = key
                conflict = {
                    self.placement[k]
                    for k in self.placement
                    if k[0] == gid
                    and k != key
                    and (k[1] == row or k[2] == col)
                    and self.available(k)
                }
                if self.nodes_per_rack is not None:
                    # rack-level anti-colocation first, node-level fallback
                    bad_racks = {self.rack_of(n) for n in conflict}
                    cands = [n for n in alive if self.rack_of(n) not in bad_racks]
                    if not cands:
                        cands = [n for n in alive if n not in conflict]
                else:
                    cands = [n for n in alive if n not in conflict]
                if not cands:
                    cands = alive
                # crc32-keyed pick (process-stable, like _place_group):
                # always taking the first candidate would funnel every
                # dense re-placement onto the lowest alive ids and turn
                # them into post-repair hotspots
                self.placement[key] = cands[
                    zlib.crc32(repr(key).encode()) % len(cands)
                ]
        blk = np.asarray(data)
        self.blocks[key] = blk
        self.checksums[key] = self.digest(blk)

    def node_of(self, key: BlockKey) -> int:
        return self.placement[key]

    def available(self, key: BlockKey) -> bool:
        return (
            key in self.blocks
            and self.placement.get(key) is not None
            and self.placement[key] not in self.failed_nodes
        )

    def get(self, key: BlockKey) -> np.ndarray:
        if not self.available(key):
            raise KeyError(f"block {key} unavailable (node failed or missing)")
        return self.blocks[key]

    def verify(self, key: BlockKey) -> bool:
        """Recompute ``key``'s digest against the one stored at PUT.
        False means silent corruption. Blocks with no stored digest
        (pre-integrity writers) pass vacuously."""
        want = self.checksums.get(key)
        if want is None or key not in self.blocks:
            return True
        return self.digest(self.blocks[key]) == want

    def verify_many(self, keys: list[BlockKey]) -> list[BlockKey]:
        """The keys of ``keys`` that fail ``verify``, in the order given,
        their digests recomputed together by ``crc32_many``."""
        todo = [k for k in keys if k in self.blocks and self.checksums.get(k) is not None]
        crcs = crc32_many([self.blocks[k] for k in todo])
        return [k for k, crc in zip(todo, crcs) if crc != self.checksums[k]]

    def checksum_ok(self, key: BlockKey, data: np.ndarray) -> bool | None:
        """Check reconstructed ``data`` against ``key``'s reference digest
        (decode-output verification). None when no digest is on file."""
        want = self.checksums.get(key)
        if want is None:
            return None
        return self.digest(data) == want

    def keys_on_node(self, node: int) -> list[BlockKey]:
        """All block keys currently placed on ``node`` (whether or not the
        node is alive) — the unit a node-level fault event acts on."""
        return [k for k, n in self.placement.items() if n == node]

    # -- failures --------------------------------------------------------------
    def fail_nodes(self, nodes: set[int] | list[int]) -> None:
        self.failed_nodes.update(int(n) for n in nodes)

    def heal_node(self, node: int) -> None:
        """Transient failure over: the node rejoins with its blocks
        intact (a reboot / network partition, not a disk loss)."""
        self.failed_nodes.discard(int(node))

    def lose_node_blocks(self, node: int) -> list[BlockKey]:
        """Permanent capacity loss: the node's blocks are destroyed (disk
        failure). The node itself rejoins the alive set empty — only a
        repair write-back can bring the data back. Returns the lost keys."""
        lost = self.keys_on_node(node)
        for key in lost:
            self.blocks.pop(key, None)
            self.placement.pop(key, None)
            self.checksums.pop(key, None)
        self.failed_nodes.discard(int(node))
        return lost

    # -- corruption ------------------------------------------------------------
    def corrupt_block(self, key: BlockKey, mode: str = "bitflip") -> bool:
        """Damage one stored block in place — the single implementation
        behind both enforced-failure-pattern tests and the scenario
        engine's ``CorruptionEvent``.

        ``bitflip`` flips one bit at a key-derived offset; ``torn``
        zeroes the trailing half (a torn write); both leave the stored
        digest STALE, so the damage is silent until a fetch or scrub
        verifies. ``erase`` destroys the bytes outright (the old
        ``drop_block`` semantics). Returns False (no-op) when the block
        holds no bytes to damage. Always writes a fresh array — callers
        (the cache, test expectations) may hold references to the old
        one."""
        blk = self.blocks.get(key)
        if blk is None:
            return False
        if mode == "erase":
            self.blocks.pop(key, None)
            return True
        flat = np.asarray(blk).copy().reshape(-1).view(np.uint8)
        if flat.size == 0:
            return False
        if mode == "bitflip":
            pos = zlib.crc32(repr(key).encode()) % flat.size
            flat[pos] ^= 1 << (zlib.crc32(repr(key).encode(), 7) % 8)
        elif mode == "torn":
            flat[flat.size // 2 :] = 0
        else:
            raise ValueError(f"unknown corruption mode {mode!r}")
        self.blocks[key] = flat.view(np.asarray(blk).dtype).reshape(
            np.asarray(blk).shape
        )
        return True

    def quarantine(self, key: BlockKey) -> None:
        """Detection outcome: pull corrupt bytes out of the readable set.
        Placement and the reference digest survive, so repair re-puts the
        block on its original node and the repaired bytes can be verified
        against the original content digest."""
        self.blocks.pop(key, None)

    def drop_block(self, key: BlockKey) -> None:
        """Targeted single-block erasure (for enforced failure patterns).
        Thin wrapper over the unified corruption path."""
        self.corrupt_block(key, mode="erase")

    def failure_matrix(self, group_id: str, rows: int, cols: int) -> np.ndarray:
        fm = np.zeros((rows, cols), dtype=bool)
        for r in range(rows):
            for c in range(cols):
                fm[r, c] = not self.available((group_id, r, c))
        return fm

    def alive_nodes(self) -> list[int]:
        return [n for n in range(self.num_nodes) if n not in self.failed_nodes]
