"""Mesh-axis names and the serve plan, for one card.

The JAX package shards over a (data, model) mesh; the port serves on one
card with no mesh, so ``SINGLE`` is the only layout it takes and
``make_serve_plan`` returns the empty plan for it. The reference's
``constrain`` has no counterpart: with no mesh it is the identity, and
the port's model code does not call it. The types stay so that the model
functions keep the reference's signatures.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MeshAxes:
    dp: tuple[str, ...] = ("data",)  # batch axes (includes 'pod' when present)
    fsdp: str | tuple | None = "data"  # parameter-shard axis (or axes)
    tp: str | None = "model"  # tensor-parallel axis
    dp_size: int = 1  # product of dp axis sizes
    fsdp_size: int = 1
    tp_size: int = 1


SINGLE = MeshAxes(dp=(), fsdp=None, tp=None)


@dataclass(frozen=True)
class ServePlan:
    """How a decode-shape cell shards its cache (nothing, on one card).

    batch_axes — mesh axes sharding the request batch dim.
    seq_axes   — mesh axes sharding the cache sequence dim.
    kv_axes    — tp axis on the KV-head dim, or None.
    """

    batch_axes: tuple[str, ...] = ()
    seq_axes: tuple[str, ...] = ()
    kv_axes: str | None = None


def make_serve_plan(cfg, ax: MeshAxes, batch: int, cache_len: int) -> ServePlan:
    """The decode cache layout: the empty plan on one card. A sharded
    mesh raises (multi-card serving is not ported)."""
    if ax.tp is None and not ax.dp:
        return ServePlan()
    raise NotImplementedError("the port serves on one card: pass SINGLE")

