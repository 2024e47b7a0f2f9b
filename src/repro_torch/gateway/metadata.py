"""Namespace metadata plane + consistent-hash shard directory.

The namenode/datanode split, in-process: ``MetadataPlane`` owns
everything about the NAMESPACE — object -> (group, row) stripe maps,
group membership, ground truth, tombstones, fault bookkeeping shared by
every data-path actor, and the object -> shard directory — while
``ObjectGateway`` shards own only data-path state (cache contents,
engine pool, coalescer, repair queue). N gateway shards constructed
over one plane serve one namespace over one ``BlockStore``/fabric;
a single unsharded gateway builds a private plane and behaves exactly
as before.

Routing is CONSISTENT HASHING (the crc32 placement hash from the block
store, lifted to the namespace): each shard projects ``vnodes`` virtual
points onto a 32-bit ring, an object id routes to the first live point
clockwise of its hash. Killing a shard removes only that shard's
points, so exactly the dead shard's ranges move to survivors — the
whole-shard-death failover reassigns namespace WITHOUT reshuffling
objects that never lived there (asserted by the failover test).

Cache coherence: every shard registers its LRU/negative cache with the
plane; invalidation-style events (PUT overwrites, corruption
tombstones, repair heals, node recovers) fan out to ``caches`` so no
shard serves a stale or known-down block another shard learned about
first.
"""

from __future__ import annotations

import zlib

BlockKey = tuple[str, int, int]


def _mix(h: int) -> int:
    """Murmur3 finalizer over a crc32 seed. crc32 alone is GF(2)-LINEAR:
    the points of two shards at the same vnode index differ by a
    constant xor, so whole point sets land in correlated clusters and
    the ring's arcs skew badly (measured: 34 vs 6 of 80 groups on a
    4-shard ring). The finalizer's multiply-xorshift rounds break the
    linearity; the crc32 stays as the stable, process-independent seed.
    """
    h &= 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def ring_hash(key: str) -> int:
    """Position of ``key`` on the 32-bit ring (crc32 seed, mixed)."""
    return _mix(zlib.crc32(key.encode()))


class ShardDirectory:
    """Consistent-hash ring over shard ids (crc32-keyed, process-stable).

    ``vnodes`` virtual points per shard smooth the ranges; lookups
    binary-search the sorted point list. ``remove_shard`` deletes only
    the dead shard's points — the minimal-movement property the
    failover test pins."""

    def __init__(self, shard_ids, vnodes: int = 64):
        self.vnodes = int(vnodes)
        self._points: list[tuple[int, int]] = []  # (hash, shard_id), sorted
        self._shards: set[int] = set()
        for sid in shard_ids:
            self.add_shard(sid)

    @property
    def shards(self) -> list[int]:
        return sorted(self._shards)

    def add_shard(self, shard_id: int) -> None:
        sid = int(shard_id)
        if sid in self._shards:
            return
        self._shards.add(sid)
        for v in range(self.vnodes):
            h = ring_hash(f"s{sid}#v{v}")
            self._points.append((h, sid))
        self._points.sort()

    def remove_shard(self, shard_id: int) -> None:
        sid = int(shard_id)
        if sid not in self._shards:
            return
        if len(self._shards) == 1:
            raise ValueError("cannot remove the last shard from the directory")
        self._shards.discard(sid)
        self._points = [(h, s) for h, s in self._points if s != sid]

    def _lookup(self, h: int) -> int:
        pts = self._points
        # first point at/after h, wrapping (bisect over (hash, sid) pairs)
        lo, hi = 0, len(pts)
        while lo < hi:
            mid = (lo + hi) // 2
            if pts[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        return pts[lo % len(pts)][1]

    def shard_for(self, object_id: int) -> int:
        """Owning shard of an object id (request routing)."""
        return self._lookup(ring_hash(f"o{int(object_id)}"))

    def shard_for_group(self, group_id: str) -> int:
        """Owning shard of a GROUP (repair ownership): each group's
        background repair runs on exactly one shard, so N shards split
        the repair backlog instead of racing over it."""
        return self._lookup(ring_hash(f"g:{group_id}"))


class MetadataPlane:
    """Shared namespace state for one logical gateway (1..N shards).

    Shards alias these containers directly and mutate them in place —
    the plane is the single source of truth for what exists, what is
    deleted, what is lost/healing/corrupt, and which shard owns what.
    Per-shard state (caches, pools, repair queues, hedge ledgers) stays
    on the shards; the plane only keeps the cache REGISTRY so coherence
    events can fan out."""

    def __init__(self, shard_ids=(0,), vnodes: int = 64):
        self.directory = ShardDirectory(shard_ids, vnodes=vnodes)
        # namespace maps (ObjectGateway.load_objects / PUT path fill these)
        self.objects: dict[int, tuple[str, int]] = {}  # oid -> (gid, row)
        self.groups: dict[str, list[int]] = {}  # gid -> member oids
        self.expected: dict = {}  # oid -> ground-truth (k, q) array
        self.deleted: set[int] = set()  # tombstoned oids
        self.block_bytes: int = 0
        # fault bookkeeping shared by every shard's planner/repair/audit
        self.lost_at: dict[BlockKey, float] = {}
        self.healing: dict[BlockKey, float] = {}
        self.corrupted_at: dict[BlockKey, float] = {}
        self.repair_stuck: dict[str, frozenset] = {}
        self.reprice_on_heal: set[BlockKey] = set()
        # registered per-shard block caches (coherence fan-out targets)
        self.caches: list = []

    # -- cache coherence -------------------------------------------------------
    def register_cache(self, cache) -> None:
        if cache is not None and cache not in self.caches:
            self.caches.append(cache)

    def unregister_cache(self, cache) -> None:
        if cache in self.caches:
            self.caches.remove(cache)

    def put_negative(self, key: BlockKey, now: float, ttl: float) -> None:
        """Tombstone ``key`` in EVERY shard's negative cache."""
        for cache in self.caches:
            cache.put_negative(key, now, ttl)

    def purge_negative(self, keys) -> int:
        """Drop negative entries for ``keys`` across every shard;
        returns how many live entries died cluster-wide."""
        keys = list(keys)
        return sum(cache.purge_negative(keys) for cache in self.caches)

    def invalidate(self, key: BlockKey) -> None:
        """Evict stale bytes for ``key`` from EVERY shard's cache (a PUT
        overwrote the block, or repair rewrote it)."""
        for cache in self.caches:
            cache.invalidate(key)

    def refresh_cost(self, key: BlockKey, cost: float) -> None:
        for cache in self.caches:
            cache.refresh_cost(key, cost)

    # -- routing ---------------------------------------------------------------
    def shard_for(self, object_id: int) -> int:
        return self.directory.shard_for(object_id)

    def owns_group(self, shard_id: int | None, group_id: str) -> bool:
        """Repair-ownership filter. Unsharded gateways (shard_id None)
        own everything; a live shard owns the groups the directory
        hashes to it (redistributed automatically when a shard dies)."""
        if shard_id is None:
            return True
        return self.directory.shard_for_group(group_id) == shard_id
