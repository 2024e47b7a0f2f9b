"""Mesh-axis abstraction and sharding-constraint helpers
(src/repro/models/shardings.py), on ``torch.distributed``'s DTensor.

The production mesh is (data, model) or (pod, data, model); smoke tests
run on one device with no mesh. ``constrain`` is the identity on a plain
tensor, so model code is mesh-agnostic.

Logical sharding rules (as in the reference):
  batch    -> (pod, data)          activations' leading dim
  seq      -> model                sequence-sharded residual saves (Megatron-SP)
  heads    -> model                q-head / TP dim
  d_ff     -> model                TP dim of MLP hidden
  vocab    -> model                logits TP
  fsdp     -> data                 parameter/optimizer FSDP dim
  experts  -> model (if divisible) EP dim

The reference's specs are JAX ``PartitionSpec``s; the port's are ``P``,
a tuple of the same entries (None, an axis name, or a tuple of names)
normalised as JAX normalises them, so a spec tree compares equal to the
reference's as tuples. ``placements`` turns a ``P`` into the DTensor
placements of one mesh: the mesh dims named in entry ``d`` shard tensor
dim ``d``, every other mesh dim replicates. The mesh in context
(``launch.mesh.mesh_context``) stands for the reference's abstract mesh:
``has_mesh`` reads it.
"""

from __future__ import annotations

import contextlib
import sys
from dataclasses import dataclass

import torch


class P(tuple):
    """A PartitionSpec: one entry per tensor dim (trailing dims left out
    are replicated), each None, a mesh axis name, or a tuple of names
    (major to minor). An empty tuple becomes None and a one-name tuple
    the bare name, as in JAX."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class MeshAxes:
    dp: tuple[str, ...] = ("data",)  # batch axes (includes 'pod' when present)
    fsdp: str | tuple | None = "data"  # parameter-shard axis (or axes)
    tp: str | None = "model"  # tensor-parallel axis
    dp_size: int = 1  # product of dp axis sizes
    fsdp_size: int = 1
    tp_size: int = 1

    @property
    def all_seq(self) -> tuple[str, ...]:
        """Axes jointly sharding a long KV-cache sequence dim."""
        return tuple(a for a in (*self.dp, self.tp) if a)

    @property
    def all_seq_size(self) -> int:
        return self.dp_size * self.tp_size

    def tp_divides(self, dim: int) -> bool:
        return self.tp is not None and dim % self.tp_size == 0

    def fsdp_divides(self, dim: int) -> bool:
        return self.fsdp is not None and dim % self.fsdp_size == 0

    def fsdp_if(self, dim: int):
        return self.fsdp if self.fsdp_divides(dim) else None

    def tp_if(self, dim: int):
        return self.tp if self.tp_divides(dim) else None

    def dp_if(self, batch: int) -> tuple[str, ...]:
        """The dp axes when they divide ``batch``, else none (a batch of
        1 is whole on every rank)."""
        return self.dp if batch % max(self.dp_size, 1) == 0 else ()


SINGLE = MeshAxes(dp=(), fsdp=None, tp=None)


@dataclass(frozen=True)
class ServePlan:
    """How a decode-shape cell shards its KV cache / recurrent state.

    batch_axes — mesh axes sharding the request batch dim (() when B=1).
    seq_axes   — mesh axes sharding the cache sequence dim; non-empty
                 selects the flash-combine decode path
                 (``layers.attention_decode_general``).
    kv_axes    — tp axis on the KV-head dim, or None.
    """

    batch_axes: tuple[str, ...] = ()
    seq_axes: tuple[str, ...] = ()
    kv_axes: str | None = None


def make_serve_plan(cfg, ax: MeshAxes, batch: int, cache_len: int) -> ServePlan:
    """Pick the decode cache layout for (arch, batch, cache_len).

    Priority: shard KV heads on tp when divisible (cheapest — pure local
    attention); otherwise shard the cache sequence dim on tp; for B == 1
    (long_500k) spread the sequence over every mesh axis."""
    if ax.tp is None and not ax.dp:
        return ServePlan()
    batch_axes = ax.dp if (ax.dp and batch % ax.dp_size == 0 and batch >= ax.dp_size) else ()
    kv = getattr(cfg, "num_kv_heads", 0) or 0
    if not batch_axes:
        seq_axes = tuple(a for a in (*ax.dp, ax.tp) if a)
        sz = 1
        for a in seq_axes:
            sz *= ax.dp_size if a in ax.dp else ax.tp_size
        if cache_len and cache_len % max(sz, 1) == 0:
            return ServePlan(batch_axes=(), seq_axes=seq_axes, kv_axes=None)
        return ServePlan()
    if ax.tp and kv and kv % ax.tp_size == 0:
        return ServePlan(batch_axes=batch_axes, seq_axes=(), kv_axes=ax.tp)
    if ax.tp and cache_len and cache_len % ax.tp_size == 0:
        return ServePlan(batch_axes=batch_axes, seq_axes=(ax.tp,), kv_axes=None)
    return ServePlan(batch_axes=batch_axes)


def axes_for_mesh(mesh, strategy: str = "2d") -> MeshAxes:
    """``mesh``: a ``DeviceMesh`` with named dims. strategy:
      "2d"   — batch on (pod, data); params FSDP on data, TP on model
               (Megatron x ZeRO; the default and the decode/prefill mode).
      "fsdp" — no tensor parallelism: batch on (pod, data, model) when it
               divides, params FSDP over (data, model).
      "tp_only" — serving mode: params replicated over data, TP over
               model."""
    names = tuple(mesh.mesh_dim_names)
    shape = dict(zip(names, mesh.mesh.shape))
    if strategy == "tp_only":
        dp = tuple(a for a in ("pod", "data") if a in names)
        dp_size = 1
        for a in dp:
            dp_size *= shape[a]
        return MeshAxes(dp=dp, fsdp=None, tp="model" if "model" in names else None,
                        dp_size=dp_size, fsdp_size=1, tp_size=shape.get("model", 1))
    if strategy == "fsdp":
        fsdp_axes = tuple(a for a in ("data", "model") if a in names)
        fsdp_size = 1
        for a in fsdp_axes:
            fsdp_size *= shape[a]
        dp = tuple(a for a in ("pod", *fsdp_axes) if a in names)
        dp_size = 1
        for a in dp:
            dp_size *= shape[a]
        return MeshAxes(dp=dp, fsdp=fsdp_axes, tp=None, dp_size=dp_size,
                        fsdp_size=fsdp_size, tp_size=1)
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp_size = 1
    for a in dp:
        dp_size *= shape[a]
    return MeshAxes(
        dp=dp,
        fsdp="data" if "data" in names else None,
        tp="model" if "model" in names else None,
        dp_size=dp_size,
        fsdp_size=shape.get("data", 1),
        tp_size=shape.get("model", 1),
    )


# -- the mesh in context ----------------------------------------------------

_MESH: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the mesh in context (``has_mesh``) for the block."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def current_mesh():
    """The mesh in context, or None."""
    return _MESH[-1] if _MESH else None


def has_mesh() -> bool:
    m = current_mesh()
    return m is not None and m.mesh.numel() > 0


# -- specs as DTensor placements ---------------------------------------------


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: mesh dim ``i``
    gives ``Shard(d)`` when entry ``d`` names it, else ``Replicate()``.
    Where one entry names several axes, DTensor shards them in mesh-dim
    order, which must be the entry's major-to-minor order: raises
    ValueError when it is not, when an axis is not the mesh's, or when
    an axis is named twice."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    seen: set = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: axis {a!r} is not one of the mesh's {names}")
            if a in seen:
                raise ValueError(f"{spec}: axis {a!r} named twice")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"{spec}: entry {entry} shards major to minor against the mesh order "
                f"{names}; DTensor shards in mesh-dim order")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    # no DTensor exists before its module is imported (a 2-3 s import the
    # single-device path never pays)
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and isinstance(x, dtensor.DTensor)


def distribute(t: torch.Tensor, spec: P, mesh, src_rank: int | None = None) -> torch.Tensor:
    """``t`` as a DTensor laid out by ``spec`` on ``mesh``. With
    ``src_rank`` None every rank holds the same global value and keeps
    its own shard, with no communication; else the value is ``src_rank``'s
    (the other ranks pass a tensor of the same shape and dtype)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(spec, mesh), src_data_rank=src_rank)


def laid_out_as(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` (every rank's same global value) as a DTensor with ``ref``'s
    mesh and placements when ``ref`` is a DTensor (a zero state beside a
    sharded activation, kept from forcing it whole); else ``t``."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, ref.device_mesh, ref.placements, src_data_rank=None)


def gather_inner(x):
    """A DTensor with its inner dims (neither the first nor the last)
    gathered: what a projection of a sequence-sharded residual needs
    (Megatron-SP's all-gather). torch 2.11's matmul refuses to flatten
    (B, S, d) to (B * S, d) with S sharded; the identity on a plain
    tensor and on a DTensor whose inner dims are whole."""
    if not is_dtensor(x) or x.dim() < 3:
        return x
    from torch.distributed.tensor import Replicate, Shard

    inner = lambda p: isinstance(p, Shard) and 0 < p.dim % x.dim() < x.dim() - 1
    if not any(inner(p) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if inner(p) else p for p in x.placements])


def pin_grad(y):
    """The identity on a DTensor's value, whose gradient is laid out as
    ``y`` is before it flows on (a redistribute to ``y``'s own placements:
    DTensor's backward redistributes the gradient to the forward input's).
    A matmul's backward views its output gradient (B, S, F) as (B * S, F),
    which torch 2.11 refuses when the gradient arrives sequence-sharded
    from a residual add. The identity on a plain tensor."""
    if not is_dtensor(y):
        return y
    return y.redistribute(y.device_mesh, y.placements)


def constrain(x, spec: P):
    """The identity on a plain tensor; a DTensor redistributed to
    ``spec``'s placements on its own mesh."""
    if not is_dtensor(x):
        return x
    pl = placements(spec, x.device_mesh)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)

