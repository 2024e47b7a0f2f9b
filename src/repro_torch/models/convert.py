"""Weights and optimizer state between the JAX package's layout and the
port's models (``MambaLM`` for the ssm family, ``TransformerLM`` for
dense and vlm), both ways.

The reference stacks each layer leaf on a leading ``L`` axis; the port
keeps one module per layer, so the axis is sliced into ``layers.<i>``,
and a tree path ``a/b/c`` becomes the state dict key ``a.b.c``.
``stacked_tree`` goes the other way, and ``load_stacked`` writes a
stacked tree back into the layer modules: the optimizer works on the
stacked layout (train/optimizer.py). The optimizer state itself is kept
stacked, so it moves between the packages by ``tree_to`` alone.

Leaves keep their dtype unless ``dtype`` names one for every floating
leaf. A bfloat16 leaf arrives from JAX as an ``ml_dtypes.bfloat16``
array, which ``torch.from_numpy`` refuses: it is recognised by its
dtype's name, widened to float32 (exact) and narrowed to
``torch.bfloat16`` (exact again). The port does not import
``ml_dtypes``, so its own trees hold torch tensors (CPU tensors on the
way out), whose bytes and dtype names are the reference's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.registry import get_model


def to_tensor(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A numpy array (bfloat16 by its dtype's name) or a tensor, as a
    tensor of its own on ``device``."""
    own = not isinstance(a, torch.Tensor)
    if not own:
        t = a.detach()
    elif np.asarray(a).dtype.name == "bfloat16":
        t = torch.from_numpy(np.asarray(a).astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point() and t.dtype != dtype:
        t, own = t.to(dtype), True
    return t.to(device, copy=not own)


def tree_to(tree, device, dtype: torch.dtype | None = None):
    """Every leaf of nested dicts, lists and tuples (numpy arrays or
    tensors) as a tensor on ``device``: the optimizer state in either
    direction (``device="cpu"`` for the way out)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device, dtype) for v in tree)
    return to_tensor(tree, device, dtype)


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, path + ".")
        else:
            yield path, val


def _put(tree: dict, path: list[str], leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def _get(tree: dict, path: list[str]):
    for key in path:
        tree = tree[key]
    return tree


def _split(name: str) -> tuple[list[str], int | None]:
    """``layers.3.in_proj.w`` -> (["layers", "in_proj", "w"], 3);
    ``ln_f.scale`` -> (["ln_f", "scale"], None)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ["layers", *parts[2:]], int(parts[1])
    return parts, None


def from_jax(tree: dict, cfg: ArchConfig, *, device=None,
             dtype: torch.dtype | None = None, trainable: bool = False) -> nn.Module:
    """``tree``: the reference's ``init_lm`` output for ``cfg``'s family
    as numpy leaves (``jax.tree.map(np.asarray, params)``), or
    ``stacked_tree``'s output. Returns the family's model on ``device``
    holding exactly those values (cast to ``dtype`` when given); its
    parameters require grad when ``trainable``. An unported family
    raises ``NotImplementedError`` (the registry's)."""
    model = get_model(cfg).init(cfg, None, device=device)
    state = {}
    for path, leaf in _flatten(tree):
        if path.startswith("layers."):
            rest = path[len("layers."):]
            for i in range(cfg.num_layers):
                state[f"layers.{i}.{rest}"] = to_tensor(leaf[i], model.device, dtype)
        else:
            state[path] = to_tensor(leaf, model.device, dtype)
    model.load_state_dict(state, strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(trainable)
    return model


def stacked_tree(model: nn.Module, values=None) -> dict:
    """The reference's stacked tree of ``model``'s parameters (detached),
    or of ``values``, one tensor per parameter in ``model.parameters()``
    order (its gradients), on their own device."""
    names = [name for name, _ in model.named_parameters()]
    leaves = [p.detach() for p in model.parameters()] if values is None else list(values)
    tree: dict = {}
    per_layer: dict[tuple[str, ...], list] = {}
    for name, leaf in zip(names, leaves, strict=True):
        path, layer = _split(name)
        if layer is None:
            _put(tree, path, leaf)
        else:
            per_layer.setdefault(tuple(path), []).append(leaf)
    for path, stack in per_layer.items():
        _put(tree, list(path), torch.stack(stack))
    return tree


def to_reference_tree(model: nn.Module) -> dict:
    """``model``'s parameters as the reference's stacked tree of CPU
    tensors, each in its parameter's dtype: the bytes the reference's
    ``np.asarray`` of the same parameters holds."""
    return tree_to(stacked_tree(model), "cpu")


@torch.no_grad()
def load_stacked(model: nn.Module, tree: dict) -> None:
    """Write a stacked tree's values into ``model``'s parameters, in
    place (dtype and device of each parameter kept)."""
    for name, p in model.named_parameters():
        path, layer = _split(name)
        leaf = _get(tree, path)
        p.copy_(leaf if layer is None else leaf[layer])
