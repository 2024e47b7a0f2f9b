"""Mesh builders (src/repro/launch/mesh.py) on ``torch.distributed``.

The reference builds a JAX mesh over the devices of one process. Here
ranks are processes: a mesh is a ``DeviceMesh`` over the ranks of the
default process group (``init_ranks`` starts it), one rank per card on
``cuda`` (NCCL), any number of ranks on ``cpu`` (gloo). The device type
comes from the caller's ``device``: the card by default (raises without
one), the CPU when asked. The builders are functions, so importing this
module touches no process group.

The production meshes keep the reference's TPU pod shapes, 16 x 16 and
2 x 16 x 16; ``make_production_mesh`` raises ValueError when the world
is smaller.
"""

from __future__ import annotations

import contextlib
import datetime
import math

import torch
import torch.distributed as dist

from repro_torch.kernels.backend import resolve_device
from repro_torch.models.shardings import use_mesh


def init_ranks(rank: int, world: int, rendezvous: str, device=None,
               timeout_s: float = 300.0) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` through
    ``rendezvous`` (``file://<path>`` or ``tcp://host:port``): NCCL on
    the card (rank ``r`` takes card ``r``), gloo on the CPU. A rank that
    does not arrive fails the others after ``timeout_s``. Returns this
    rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if world > torch.cuda.device_count():
            raise ValueError(f"{world} ranks need {world} cards (NCCL takes one rank per "
                             f"card); this host has {torch.cuda.device_count()}")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=rendezvous, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], devices=None, *, device=None):
    """A mesh of ``shape`` named ``axes`` over ``devices`` (global ranks,
    row-major) or the first prod(shape) ranks."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    n = math.prod(shape)
    kind = resolve_device(device).type
    if devices is None:
        if n > dist.get_world_size():
            raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                             f"{dist.get_world_size()}")
        if n == dist.get_world_size():
            return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))
        devices = range(n)
    ranks = torch.tensor(list(devices), dtype=torch.int64).reshape(shape)
    return DeviceMesh(kind, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise ValueError(f"the production mesh {shape} is a TPU pod of {n} chips; this "
                         f"world has {world} ranks")
    return make_mesh(shape, axes, device=device)


def mesh_context(mesh):
    """The mesh in context for model code (``shardings.has_mesh``), with
    DTensor's implicit replication on: a plain tensor that meets a
    DTensor (a mask, an ``arange``, a zero accumulator) is taken as
    replicated, as the reference's jit takes a constant."""
    from torch.distributed.tensor.experimental import implicit_replication

    stack = contextlib.ExitStack()
    stack.enter_context(use_mesh(mesh))
    stack.enter_context(implicit_replication())
    return stack


def make_host_mesh(n_data: int = 1, n_model: int = 1, *, device=None):
    """Small (data, model) mesh over the first n_data * n_model ranks (tests)."""
    return make_mesh((n_data, n_model), ("data", "model"), device=device)
