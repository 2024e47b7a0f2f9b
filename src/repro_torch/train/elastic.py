"""Elasticity & resilience runtime: failure detection, spare-host
remapping, straggler monitoring.

At 1000+-node scale the control flow is:
  1. HostMonitor sees a missed heartbeat / persistent straggler.
  2. ElasticPlan swaps the bad host for a spare (logical->physical remap;
     logical mesh shape is unchanged so no re-lowering of the step fn,
     only the device assignment changes) — or, with no spares left,
     *shrinks* the data axis to the largest divisor mesh and re-lowers.
  3. The sharded train state is restored from the latest CORE-encoded
     checkpoint (degraded restore works while the dead host's blocks are
     still missing — the paper's vertical-XOR path), and the BlockFixer
     repairs lost checkpoint blocks in the background (RGS schedule).

Everything here is host-count-agnostic and unit-tested on small fake
meshes (numpy only; the port transcribes it from src/repro/train/elastic.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Heartbeat:
    step: int
    t_wall: float
    dt_step: float


@dataclass
class HostMonitor:
    """Per-host step telemetry -> failure & straggler detection."""

    timeout_s: float = 60.0
    straggler_factor: float = 2.0
    window: int = 20
    beats: dict[str, list] = field(default_factory=dict)

    def beat(self, host: str, step: int, dt_step: float, now: float | None = None):
        now = time.monotonic() if now is None else now
        self.beats.setdefault(host, []).append(Heartbeat(step, now, dt_step))
        if len(self.beats[host]) > self.window:
            self.beats[host] = self.beats[host][-self.window:]

    def dead_hosts(self, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [h for h, bs in self.beats.items() if now - bs[-1].t_wall > self.timeout_s]

    def stragglers(self) -> list[str]:
        """Hosts whose median step time exceeds straggler_factor x the
        fleet median."""
        if len(self.beats) < 2:
            return []
        med = {h: float(np.median([b.dt_step for b in bs])) for h, bs in self.beats.items()}
        fleet = float(np.median(list(med.values())))
        return [h for h, m in med.items() if m > self.straggler_factor * fleet]


@dataclass
class ElasticPlan:
    """Logical->physical host mapping with a spare pool.

    hosts: active physical host ids, in logical order (mesh position i is
    served by hosts[i]). spares: idle replacements.
    """

    hosts: list[int]
    spares: list[int] = field(default_factory=list)
    remaps: list[tuple[int, int]] = field(default_factory=list)

    def replace(self, failed: int) -> tuple[int, int]:
        """Swap a failed host for a spare; returns (logical_pos, new_host).
        Raises IndexError when the spare pool is exhausted."""
        pos = self.hosts.index(failed)
        new = self.spares.pop(0)
        self.hosts[pos] = new
        self.remaps.append((failed, new))
        return pos, new

    def shrink_to(self, n: int) -> list[int]:
        """Drop to n hosts (largest-divisor shrink when out of spares);
        returns the released hosts (their shards must be re-balanced from
        the CORE checkpoint restore)."""
        released, self.hosts = self.hosts[n:], self.hosts[:n]
        return released


def largest_divisor_leq(total: int, cap: int) -> int:
    d = min(cap, total)
    while total % d:
        d -= 1
    return d


def shrink_mesh_shape(dp: int, failed_count: int) -> int:
    """New data-axis size after losing ``failed_count`` hosts with no
    spares: the largest divisor of the original dp that fits the
    surviving host count (keeps global batch divisible)."""
    return largest_divisor_leq(dp, dp - failed_count)


def device_permutation(num_devices: int, plan: ElasticPlan,
                       devices_per_host: int) -> np.ndarray:
    """Physical device order realizing the plan's logical host order."""
    order = []
    for h in plan.hosts:
        order.extend(range(h * devices_per_host, (h + 1) * devices_per_host))
    return np.asarray(order[:num_devices])
