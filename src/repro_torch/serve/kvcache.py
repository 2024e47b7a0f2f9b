"""Cache management for serving: layout planning + a slot-based
continuous-batching manager.

On one card the layout plan is the empty one (models/shardings.py). The
request-level bookkeeping is the reference's, transcribed: fixed-slot
continuous batching (a finished request frees its slot; a waiting
request claims it and is prefilled into the shared cache).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.models.registry import ModelApi
from repro_torch.models.shardings import MeshAxes, ServePlan, make_serve_plan
from repro_torch.models.stack import tree_leaves


def plan_for(cfg: ArchConfig, ax: MeshAxes, batch: int, cache_len: int) -> ServePlan:
    return make_serve_plan(cfg, ax, batch, cache_len)


def cache_bytes(cfg: ArchConfig, api: ModelApi, batch: int, cache_len: int) -> int:
    """Bytes of every leaf of the family's cache tree (the hybrid's
    nests ``groups`` and a ``tail`` list)."""
    specs = api.cache_shape(cfg, batch, cache_len)
    return sum(math.prod(s.shape) * s.dtype.itemsize for s in tree_leaves(specs))


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    generated: list[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new


@dataclass
class SlotManager:
    """Fixed-B continuous batching: slot i of the batched cache belongs to
    at most one live request; pos counters are per-slot."""

    batch: int
    cache_len: int
    slots: list = field(default_factory=list)
    pos: np.ndarray = None
    waiting: list = field(default_factory=list)
    finished: list = field(default_factory=list)

    def __post_init__(self):
        self.slots = [None] * self.batch
        self.pos = np.zeros((self.batch,), np.int32)

    def submit(self, req: Request):
        self.waiting.append(req)

    def admit(self) -> list[tuple[int, Request]]:
        """Fill free slots from the waiting queue; returns (slot, request)
        pairs that need prefill."""
        admitted = []
        for i in range(self.batch):
            if self.slots[i] is None and self.waiting:
                req = self.waiting.pop(0)
                self.slots[i] = req
                self.pos[i] = len(req.prompt)
                admitted.append((i, req))
        return admitted

    def step_tokens(self) -> np.ndarray:
        """Last token per slot (pad = 0 for empty slots)."""
        out = np.zeros((self.batch, 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            out[i, 0] = req.generated[-1] if req.generated else req.prompt[-1]
        return out

    def record(self, next_tokens: np.ndarray):
        """Append sampled tokens; retire finished requests."""
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.generated.append(int(next_tokens[i]))
            self.pos[i] += 1
            if req.done or self.pos[i] >= self.cache_len:
                self.finished.append(req)
                self.slots[i] = None

    @property
    def live(self) -> int:
        return sum(r is not None for r in self.slots)
