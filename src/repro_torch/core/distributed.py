"""Distributed (pipelined) vertical XOR repair (src/repro/core/distributed.py)
— the paper's footnote 3, done across the ranks of a mesh.

The paper's implementation downloads all t survivor blocks to one
repair node (serialized by that node's NIC). On a mesh the XOR reduction
runs as a log2(n)-round butterfly: each round every rank swaps its
partial with the rank whose coordinate differs in one bit and XORs the
two, so every link carries one block per round and the critical path is

    ceil(log2 t) x (block/link_bw)   vs   t x (block/node_bw)

— for (14,12,5): 3 rounds instead of 5 serialized transfers, and the
XOR compute itself is spread over all t hosts.

The reference runs the butterfly as ``ppermute`` under ``shard_map``.
Here each round is a paired ``isend`` / ``irecv`` on the process group of
the mesh axis, XOR-ing in place: NCCL has no bitwise-XOR reduction, so
``all_reduce`` cannot do it on the card. The reference pairs coordinate
i with i ^ 2^r, which leaves the axis when its size is not a power of
two; the port raises ValueError there. Padding t up to the axis size
with zero blocks keeps the butterfly exact (XOR identity).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _butterfly_rounds(n: int) -> int:
    r = 0
    while (1 << r) < n:
        r += 1
    return r


def distributed_xor_repair(blocks, mesh, axis: str = "data") -> torch.Tensor:
    """blocks: (t, q) uint8 (a tensor on the mesh's device, or a numpy
    array), the same on every rank; the rank at coordinate i of ``axis``
    holds survivor block i (t <= the axis size; missing rows are zero).
    Returns the repaired block (q,), the XOR of all rows, on every rank.
    Raises ValueError when the axis size is not a power of two or t
    exceeds it."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n & (n - 1):
        raise ValueError(f"the butterfly pairs coordinate i with i ^ 2^r: axis {axis!r} "
                         f"has {n} ranks, not a power of two")
    if isinstance(blocks, np.ndarray):
        blocks = torch.from_numpy(np.ascontiguousarray(blocks))
    t, q = blocks.shape
    if t > n:
        raise ValueError(f"{t} blocks for {n} ranks on axis {axis!r}")
    me = mesh.get_local_rank(axis)
    acc = (blocks[me].clone() if me < t
           else torch.zeros((q,), dtype=torch.uint8, device=blocks.device)).contiguous()
    group = mesh.get_group(axis)
    buf = torch.empty_like(acc)
    for r in range(_butterfly_rounds(n)):
        peer = dist.get_global_rank(group, me ^ (1 << r))
        ops = [dist.P2POp(dist.isend, acc, peer, group),
               dist.P2POp(dist.irecv, buf, peer, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        acc.bitwise_xor_(buf)
    return acc


def xor_repair_critical_path(t: int, block_bytes: int, link_bw: float,
                             node_bw: float) -> tuple[float, float]:
    """(butterfly_seconds, paper_centralized_seconds) — the analytic
    contrast reported in EXPERIMENTS.md §Perf."""
    butterfly = _butterfly_rounds(t) * block_bytes / link_bw
    centralized = t * block_bytes / node_bw
    return butterfly, centralized
