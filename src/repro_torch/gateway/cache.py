"""Block cache with hit/miss accounting and a choice of eviction policy.

Sits between the gateway and the fabric: a hit serves the block from
gateway memory (no network transfer, no reconstruction); a miss goes to
the block store. Decoded (reconstructed) blocks are cached too, so a hot
degraded object pays its reconstruction once per eviction period rather
than once per request — the standard production mitigation for repair
read amplification.

Two policies:

  * ``lru``  — plain recency (the PR-1 behavior).
  * ``cost`` — reconstruction-cost-aware (GreedyDual): each entry
    carries a rebuild cost (source blocks needed to regenerate it — 1
    for a directly-fetched block, t for a vertical XOR rebuild, k for a
    horizontal RS decode) and the victim is the entry with the lowest
    recency x cost score. A k-cost horizontal reconstruction outlives
    cheap verticals and plain fetches under pressure, exactly the
    blocks whose re-miss would hurt most. With uniform costs the policy
    degenerates to LRU.

``refresh_cost`` re-prices an entry in place — the gateway calls it when
BlockFixer repairs the underlying block, since a repaired block is a
cheap store read again and should no longer squat on cache capacity at
reconstruction priority.

Negative entries (TTL'd): a negative entry records "this block is known
to be down" with an expiry in simulated time. The gateway inserts them
for every block on a crashed node, so planning skips re-probing known
failures; they are purged eagerly on the node-recover event (the
scenario engine's transient-failure path) and when a repair write-back
heals the block, and they expire on their TTL otherwise — the backstop
that keeps stale failure knowledge from outliving an unobserved
recovery. Negative entries consume no data capacity (they hold no
bytes) and never shadow a positive copy: a cached reconstruction of a
down block still serves hits.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from repro_torch.storage.blockstore import BlockKey


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    negative_hits: int = 0  # availability probes short-circuited
    negative_expired: int = 0  # TTL lapses (stale failure knowledge)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class LRUBlockCache:
    def __init__(self, capacity_bytes: int, policy: str = "lru"):
        if policy not in ("lru", "cost"):
            raise ValueError(f"policy must be 'lru' or 'cost', got {policy!r}")
        self.capacity_bytes = int(capacity_bytes)
        self.policy = policy
        self._blocks: OrderedDict[BlockKey, np.ndarray] = OrderedDict()
        self._bytes = 0
        self.stats = CacheStats()
        # GreedyDual state (policy="cost"): per-entry score H = L + cost,
        # where L is the inflation clock — the score of the last victim.
        # Re-accessing an entry re-inflates it to the current L + cost,
        # so score order is recency order scaled by rebuild cost.
        self._cost: dict[BlockKey, float] = {}
        self._score: dict[BlockKey, float] = {}
        self._clock = 0.0
        # negative entries: key -> expiry in simulated seconds (inf for
        # "until explicitly purged"). Zero-capacity — a tombstone, not a
        # block — so they live outside the eviction loop entirely.
        self._negative: dict[BlockKey, float] = {}

    def __len__(self) -> int:
        return len(self._blocks)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __contains__(self, key: BlockKey) -> bool:
        """Membership probe with no stats / LRU side effects (planning)."""
        return key in self._blocks

    def get(self, key: BlockKey) -> np.ndarray | None:
        blk = self._blocks.get(key)
        if blk is None:
            self.stats.misses += 1
            return None
        self._blocks.move_to_end(key)
        if self.policy == "cost":
            self._score[key] = self._clock + self._cost[key]
        self.stats.hits += 1
        return blk

    def put(self, key: BlockKey, block: np.ndarray, cost: float = 1.0) -> None:
        if block.nbytes > self.capacity_bytes:
            return
        old = self._blocks.pop(key, None)
        if old is not None:
            self._bytes -= old.nbytes
        self._blocks[key] = block
        self._bytes += block.nbytes
        if self.policy == "cost":
            self._cost[key] = float(cost)
            self._score[key] = self._clock + float(cost)
        while self._bytes > self.capacity_bytes:
            victim = self._pick_victim()
            evicted = self._blocks.pop(victim)
            self._bytes -= evicted.nbytes
            self._drop_meta(victim)
            self.stats.evictions += 1

    def refresh_cost(self, key: BlockKey, cost: float) -> None:
        """Re-price a resident entry (repair made the block cheap again;
        no recency boost — only the cost component changes)."""
        if self.policy != "cost" or key not in self._blocks:
            return
        old_cost = self._cost[key]
        self._cost[key] = float(cost)
        self._score[key] += float(cost) - old_cost

    def invalidate(self, key: BlockKey) -> None:
        old = self._blocks.pop(key, None)
        if old is not None:
            self._bytes -= old.nbytes
            self._drop_meta(key)

    # -- negative / TTL entries -------------------------------------------------
    def put_negative(self, key: BlockKey, now: float, ttl: float = float("inf")) -> None:
        """Record that ``key`` is known-down as of ``now``; the entry
        expires at now + ttl unless purged first (node recover / repair)."""
        self._negative[key] = now + ttl

    def is_negative(self, key: BlockKey, now: float) -> bool:
        """True while a live negative entry covers ``key``. Expired
        entries are dropped lazily here (the TTL backstop: after it, the
        gateway re-probes the store instead of trusting stale failure
        knowledge)."""
        exp = self._negative.get(key)
        if exp is None:
            return False
        if now >= exp:
            del self._negative[key]
            self.stats.negative_expired += 1
            return False
        self.stats.negative_hits += 1
        return True

    def purge_negative(self, keys) -> int:
        """Eagerly drop negative entries (node recovered / block healed);
        returns how many were live."""
        n = 0
        for key in keys:
            if self._negative.pop(key, None) is not None:
                n += 1
        return n

    @property
    def negative_entries(self) -> int:
        return len(self._negative)

    # -- internals -------------------------------------------------------------
    def _pick_victim(self) -> BlockKey:
        if self.policy == "lru":
            return next(iter(self._blocks))
        # least score wins; ties broken LRU-first (the OrderedDict runs
        # LRU -> MRU), so uniform costs degenerate to exact LRU. The
        # linear scan is O(residents) per eviction — fine at this
        # simulation's cache sizes; a real deployment would keep a
        # lazy-invalidation min-heap instead.
        victim, best = None, float("inf")
        for key in self._blocks:
            s = self._score[key]
            if s < best:
                victim, best = key, s
        # inflate the clock to the victim's score: survivors' remaining
        # scores shrink relative to fresh insertions (aging), bounding
        # how long a high-cost entry can squat without re-access. Never
        # let it roll BACKWARDS: refresh_cost can legally demote an
        # entry's score below the current clock, and deflating the clock
        # from such a victim would hand later insertions stale scores.
        self._clock = max(self._clock, best)
        return victim

    def _drop_meta(self, key: BlockKey) -> None:
        self._cost.pop(key, None)
        self._score.pop(key, None)
