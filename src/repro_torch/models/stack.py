"""Layer stacks.

The JAX package stacks every layer's parameters on a leading ``L`` axis
and walks them with ``lax.scan``. The port keeps one module per layer in
an ``nn.ModuleList`` and walks it with a Python loop; the caches keep the
reference's stacked layout (leading ``L``). ``scan_layers`` rematerializes
each layer, as the reference's ``jax.checkpoint(policy=nothing_saveable)``
body does: backward recomputes a layer from its input, so the saved
activations are one residual per layer. With ``block`` it is the
reference's two-level remat: each block of ``block`` layers keeps only
its input, and while a block's backward recomputes it, each layer inside
keeps only its own.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def stacked_init(init_fn: Callable[[], nn.Module], num: int) -> nn.ModuleList:
    """``num`` layers from ``init_fn``, each drawn in turn."""
    return nn.ModuleList(init_fn() for _ in range(num))


def stacked_specs(specs, prefix_dim=None):
    """Prepend a (replicated) layer dim to every ``P`` leaf."""
    from repro_torch.models.shardings import P

    return tree_map(lambda s: P(prefix_dim, *s), specs)


def remat(fn: Callable, *args):
    """``fn(*args)``, keeping only ``args`` for backward (the bodies are
    deterministic, so no RNG state is saved)."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def scan_layers(body: Callable, x: torch.Tensor, layers: nn.ModuleList, *,
                block: int = 0) -> torch.Tensor:
    """x -> fold ``body(x, layer) -> x`` over the layers, each layer
    rematerialized. ``block`` > 0 (taken only when it divides a larger
    layer count, as in the reference) checkpoints each block of
    ``block`` layers around the per-layer fold: the saved activations
    shrink from one residual per layer to one per block, at the cost of
    about one more forward pass."""
    num = len(layers)
    if block and num > block and num % block == 0:
        def block_body(h, *blk):
            return scan_layers(body, h, blk)

        for g in range(0, num, block):
            x = remat(block_body, x, *layers[g : g + block])
        return x
    for layer in layers:
        x = remat(body, x, layer)
    return x


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (and of ``rest``,
    trees of the same structure), as ``jax.tree.map``; a tuple is a leaf
    (the optimizer's int8 (q, scale) pair)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_paths(tree, prefix: str = "") -> dict:
    """{path: leaf} of nested dicts and lists, each path the keys and
    list indices on the way joined by dots (``tail.0.mix.lru.lam``): a
    parameter tree's paths are its module's ``state_dict`` keys."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    return {path: leaf for key, sub in items
            for path, leaf in tree_paths(sub, f"{prefix}.{key}" if prefix else str(key)).items()}


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def scan_layers_with_cache(body: Callable, x: torch.Tensor, layers: nn.ModuleList,
                           cache):
    """Fold ``body(x, layer, layer_cache) -> (x, new_layer_cache)`` over
    the layers. ``cache`` is a tree (nested dicts and lists, as
    ``lax.scan`` walks a pytree) of tensors with a leading L, or
    ``None``, which gives every layer ``None``; returns x and the new
    caches stacked on L in the same tree."""
    outs = []
    for i, layer in enumerate(layers):
        x, new = body(x, layer, None if cache is None else tree_map(lambda t: t[i], cache))
        outs.append(new)
    return x, tree_map(lambda *ts: torch.stack(ts), *outs)
