"""The one traffic generator: it reads a cell's workload file
(``portbench/workloads/<cell>.json``) and draws everything from the seed.

Keys of a workload file that this module reads:

- ``loop``: ``closed`` (``outstanding`` requests of distinct objects per
  ``serve`` call, back to back), ``open`` (``rate`` requests a second on
  the wall clock, each handed to ``serve`` once it is due) or ``losses``
  (nodes lose their disks one after another, in ``loss_order``);
- ``mix``: the share of each request kind (``get``, ``put``);
- ``keys``: ``all`` objects, or ``lost_data_block``: the objects that the
  crash cost a data block;
- ``zipf_s``: the popularity exponent over those keys (YCSB's zipfian
  constant is 0.99), popular ranks mapped to a seeded permutation;
- ``even_ranks``: ``lost_data_block`` gives the objects that lost a data
  block evenly spaced popularity ranks, so the degraded share of the
  requests is the same for every seed;
- ``crash``: ``count`` nodes crash at time 0: the nodes holding the most
  data blocks, lowest id first;
- ``sim_rate``: the closed loop's simulated Poisson arrival rate;
- ``p95_limit_ms``: the latency limit ``knee.py`` holds an open loop's
  p95 to when it looks for the highest rate the program sustains.

An open loop offers a fixed number of requests, round(rate x seconds),
with exactly round(share x count) requests of each kind in a seeded
order, so every seed gets the same amount and mix of work, spaced
1 / rate apart from a seeded phase (YCSB's ``-target`` throttle
schedules its operations so).

``zipf_probs`` is a copy of ``repro_torch.gateway.workload.zipf_probs``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

KINDS = ("get", "put")


def zipf_probs(num_objects: int, s: float) -> np.ndarray:
    """Finite-catalog Zipf pmf: p(rank r) ~ r^-s, r = 1..num_objects."""
    ranks = np.arange(1, num_objects + 1, dtype=np.float64)
    w = ranks**-s
    return w / w.sum()


def streams(seed: int) -> dict[str, np.random.Generator]:
    """Independent generators for each use of the seed, so a change to one
    draw leaves the others as they were."""
    return {name: np.random.default_rng([seed, i])
            for i, name in enumerate(("keys", "kinds", "arrivals"))}


def crash_nodes(spec: dict, placement: dict, rows: int, k: int, num_nodes: int) -> list[int]:
    """The ``spec["count"]`` nodes that crash at time 0: those holding the
    most data blocks, lowest id first. ``placement`` maps (group, row,
    col) -> node."""
    held = np.zeros(num_nodes, dtype=np.int64)
    for (_g, r, c), node in placement.items():
        if r < rows - 1 and c < k:
            held[node] += 1
    return sorted(range(num_nodes), key=lambda n: (-held[n], n))[: int(spec.get("count", 1))]


def lost_data_objects(objects: dict, placement: dict, failed: set[int], k: int) -> list[int]:
    """Objects (id -> (group, row)) with a data block on a failed node."""
    return sorted(
        oid for oid, (gid, row) in objects.items()
        if any(placement.get((gid, row, c)) in failed for c in range(k))
    )


def ranked(keys: list[int], spread: set[int], rng: np.random.Generator) -> list[int]:
    """``keys`` in popularity order: a seeded permutation, except that the
    keys in ``spread`` take evenly spaced ranks (the i-th of D at rank
    floor((i + 1/2) N / D)), so they draw the same share of requests
    whatever the seed; each class is shuffled by the seed."""
    special = [k for k in keys if k in spread]
    other = [k for k in keys if k not in spread]
    special = [special[i] for i in rng.permutation(len(special))]
    other = [other[i] for i in rng.permutation(len(other))]
    n, d = len(keys), len(special)
    slots = {int((i + 0.5) * n / d): key for i, key in enumerate(special)} if d else {}
    rest = iter(other)
    return [slots[r] if r in slots else next(rest) for r in range(n)]


class KeyChooser:
    """Zipf(s) over keys given in popularity order (``ranked``)."""

    def __init__(self, order: list[int], s: float, rng: np.random.Generator):
        if not order:
            raise ValueError("the workload's key set is empty")
        self.order = order
        self.probs = zipf_probs(len(order), s)
        self.rng = rng

    def draw(self, n: int) -> list[int]:
        return [self.order[r] for r in self.rng.choice(len(self.order), size=n, p=self.probs)]

    def draw_distinct(self, n: int) -> list[int]:
        """``n`` different keys, drawn by Zipf without replacement: the
        requests one client has in flight at a time."""
        if n > len(self.order):
            raise ValueError(f"{n} distinct keys asked of {len(self.order)}")
        picked = self.rng.choice(len(self.order), size=n, replace=False, p=self.probs)
        return [self.order[r] for r in picked]


def kinds_exact(mix: dict, n: int, rng: np.random.Generator) -> list[str]:
    """Exactly round(share x n) of each kind (the last kind takes the
    rounding), in a seeded order."""
    out: list[str] = []
    named = [kind for kind in KINDS if mix.get(kind, 0.0) > 0.0]
    for kind in named[:-1]:
        out += [kind] * int(round(mix[kind] * n))
    out += [named[-1]] * (n - len(out))
    return [out[i] for i in rng.permutation(n)]


@dataclass(frozen=True)
class Due:
    """One request of an open loop: due ``at`` seconds into the window."""

    at: float
    kind: str
    object_id: int


def open_schedule(workload: dict, seconds: float, chooser: KeyChooser,
                  kinds_rng: np.random.Generator,
                  arrivals_rng: np.random.Generator) -> list[Due]:
    rate = float(workload["rate"])
    n = max(1, int(round(rate * seconds)))
    times = (np.arange(n) + arrivals_rng.uniform()) / rate
    kinds = kinds_exact(workload["mix"], n, kinds_rng)
    oids = chooser.draw(n)
    return [Due(float(t), kind, oid) for t, kind, oid in zip(times, kinds, oids)]


def loss_order(placement: dict) -> list[int]:
    """The nodes that hold a block, the most blocks first, lowest id
    first among equals. Placement does not depend on the seed, so every
    seed loses the same nodes, the same blocks, in the same order."""
    held: dict[int, int] = {}
    for node in placement.values():
        held[node] = held.get(node, 0) + 1
    return sorted(held, key=lambda n: (-held[n], n))
