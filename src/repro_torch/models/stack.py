"""Layer stacks.

The JAX package stacks every layer's parameters on a leading ``L`` axis
and walks them with ``lax.scan``. The port keeps one module per layer in
an ``nn.ModuleList`` and walks it with a Python loop; the caches keep the
reference's stacked layout (leading ``L``). ``scan_layers`` rematerializes
each layer, as the reference's ``jax.checkpoint(policy=nothing_saveable)``
body does: backward recomputes a layer from its input, so the saved
activations are one residual per layer. The reference's two-level remat
(``block``) is used only by the dense family and waits for it.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def stacked_init(init_fn: Callable[[], nn.Module], num: int) -> nn.ModuleList:
    """``num`` layers from ``init_fn``, each drawn in turn."""
    return nn.ModuleList(init_fn() for _ in range(num))


def scan_layers(body: Callable, x: torch.Tensor, layers: nn.ModuleList) -> torch.Tensor:
    """x -> fold ``body(x, layer) -> x`` over the layers, each layer
    keeping only its input for backward and recomputing the rest (the
    body is deterministic, so no RNG state is saved)."""
    for layer in layers:
        x = checkpoint(body, x, layer, use_reentrant=False, preserve_rng_state=False)
    return x


def scan_layers_with_cache(body: Callable, x: torch.Tensor, layers: nn.ModuleList,
                           cache: dict | None):
    """Fold ``body(x, layer, layer_cache) -> (x, new_layer_cache)`` over
    the layers. ``cache`` holds tensors with a leading L (``None`` gives
    every layer ``None``); returns x and the new caches stacked on L."""
    outs = []
    for i, layer in enumerate(layers):
        lc = None if cache is None else {k: v[i] for k, v in cache.items()}
        x, new = body(x, layer, lc)
        outs.append(new)
    return x, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
