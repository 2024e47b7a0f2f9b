"""Pytree <-> fixed-size byte-block partitioning for CORE checkpoints.

A checkpoint is serialized leaf-by-leaf into one byte stream per *shard
stream* (in a multi-host deployment each host serializes its local
shards; here one stream per save). The stream is chunked into
``block_size`` blocks; k consecutive blocks form one *object* (an RS
stripe); t objects form one CORE group (the cross-object dimension).

A tree is nested ``dict`` / ``list`` / ``tuple`` containers (``None`` is
an empty subtree) over leaves that are torch tensors or numpy arrays
(scalars too). Leaves are visited in the order of ``jax.tree.flatten``:
a dict's keys sorted (an ``OrderedDict``'s in its own order), lists and
tuples in order, so the byte stream does not depend on how a dict was
built. An object with ``tree_flatten`` / ``tree_unflatten`` (as
``train.train_step.TrainState``) is a node whose children are what its
``tree_flatten`` returns, in that order, as a node the reference
registers with ``jax.tree_util.register_pytree_node`` flattens. A leaf
is serialized as its raw bytes; ``LeafSpec.dtype`` is the
numpy name of its dtype (``"bfloat16"``, ``"float32"``, ``"int64"``,
...). Restored leaves are CPU tensors of the saved dtype and shape.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

LEAF = "*"


@dataclass
class LeafSpec:
    shape: tuple[int, ...]
    dtype: str
    nbytes: int


@dataclass
class StreamSpec:
    treedef: object
    leaves: list[LeafSpec]
    total_bytes: int
    block_size: int
    k: int
    t: int
    num_groups: int
    pad_bytes: int


def flatten(tree) -> tuple[list, object]:
    """``tree`` -> (leaves, treedef). The treedef is a plain nested
    tuple: ``"*"`` for a leaf, ``("none",)``, ``("list", children)``,
    ``("tuple", children)``, ``("dict", keys, children)`` (keys sorted),
    ``("odict", keys, children)`` or ``("node", type, aux, children)``."""
    leaves: list = []

    def walk(node):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = tuple(node) if isinstance(node, OrderedDict) else tuple(sorted(node))
            kind = "odict" if isinstance(node, OrderedDict) else "dict"
            return (kind, keys, tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, tuple(walk(c) for c in node))
        if hasattr(node, "tree_flatten"):
            children, aux = node.tree_flatten()
            return ("node", type(node), aux, tuple(walk(c) for c in children))
        leaves.append(node)
        return LEAF

    return leaves, walk(tree)


def unflatten(treedef, leaves) -> object:
    it = iter(leaves)

    def build(node):
        if node == LEAF:
            return next(it)
        kind = node[0]
        if kind == "none":
            return None
        if kind in ("dict", "odict"):
            items = [(k, build(c)) for k, c in zip(node[1], node[2])]
            return OrderedDict(items) if kind == "odict" else dict(items)
        if kind == "node":
            return node[1].tree_unflatten(node[2], [build(c) for c in node[3]])
        children = [build(c) for c in node[1]]
        return children if kind == "list" else tuple(children)

    return build(treedef)


def _leaf_bytes(leaf) -> tuple[LeafSpec, bytes]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        dtype = str(t.dtype).removeprefix("torch.")
        return LeafSpec(shape=tuple(t.shape), dtype=dtype, nbytes=len(raw)), raw
    arr = np.asarray(leaf)
    return LeafSpec(shape=arr.shape, dtype=str(arr.dtype), nbytes=arr.nbytes), arr.tobytes()


def tree_to_stream(tree) -> tuple[bytes, object, list[LeafSpec]]:
    leaves, treedef = flatten(tree)
    specs, chunks = [], []
    for leaf in leaves:
        spec, raw = _leaf_bytes(leaf)
        specs.append(spec)
        chunks.append(raw)
    return b"".join(chunks), treedef, specs


def stream_to_tree(stream: bytes, treedef, specs: list[LeafSpec]):
    data = torch.from_numpy(np.frombuffer(stream, dtype=np.uint8).copy())
    leaves = []
    off = 0
    for spec in specs:
        dtype = getattr(torch, spec.dtype, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"leaf dtype {spec.dtype!r} has no torch counterpart")
        # a copy of its own: the leaf's storage starts aligned for its dtype
        raw = data[off : off + spec.nbytes].clone()
        off += spec.nbytes
        leaves.append(raw.view(dtype).reshape(spec.shape))
    return unflatten(treedef, leaves)


def stream_to_objects(
    stream: bytes, block_size: int, k: int, t: int
) -> tuple[np.ndarray, int, int]:
    """bytes -> ((num_groups, t, k, block_size) uint8 object array
    (padded), pad bytes, num_groups)."""
    data = np.frombuffer(stream, dtype=np.uint8)
    group_bytes = block_size * k * t
    pad = (-data.size) % group_bytes
    if pad:
        data = np.concatenate([data, np.zeros(pad, dtype=np.uint8)])
    num_groups = data.size // group_bytes
    objects = data.reshape(num_groups, t, k, block_size)
    return objects, pad, num_groups


def objects_to_stream(objects: np.ndarray, total_bytes: int) -> bytes:
    return objects.reshape(-1).tobytes()[:total_bytes]
