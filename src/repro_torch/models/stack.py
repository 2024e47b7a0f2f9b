"""Layer stacks.

The JAX package stacks every layer's parameters on a leading ``L`` axis
and walks them with ``lax.scan``. The port keeps one module per layer in
an ``nn.ModuleList`` and walks it with a Python loop; the caches keep the
reference's stacked layout (leading ``L``). Remat has no counterpart:
serving keeps no activations for a backward pass.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def stacked_init(init_fn: Callable[[], nn.Module], num: int) -> nn.ModuleList:
    """``num`` layers from ``init_fn``, each drawn in turn."""
    return nn.ModuleList(init_fn() for _ in range(num))


def scan_layers(body: Callable, x: torch.Tensor, layers: nn.ModuleList) -> torch.Tensor:
    """x -> fold ``body(x, layer) -> x`` over the layers."""
    for layer in layers:
        x = body(x, layer)
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
