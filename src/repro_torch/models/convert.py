"""Weights and optimizer state between the JAX package's layout and the
port's models (``MambaLM``, ``TransformerLM``, ``HybridLM``,
``EncDecLM``), both ways.

The reference stacks each layer leaf of a layer stack (``layers``; the
hybrid's ``groups``; the encdec's ``enc`` and ``dec``) on a leading axis;
the port keeps one module per layer, so the axis is sliced into
``layers.<i>`` (``groups.<i>``, ...), and a tree path ``a/b/c`` becomes
the state dict key ``a.b.c``. The hybrid's ``tail`` is a list in the
reference's tree, one unstacked block each (``tail/<i>/...``), and a
``ModuleList`` in the port (``tail.<i>....``): its leaves keep their
own shapes both ways.
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
from repro_torch.models.stack import tree_paths


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


STACKS = ("layers", "groups", "enc", "dec")  # stacked on a leading axis
LISTS = ("tail",)  # a list of unstacked layers


def _put(tree: dict, path: list, leaf) -> None:
    """Set ``leaf`` at ``path`` (str keys of dicts, int indices of
    lists), creating the containers on the way; a list grows in order."""
    for key, nxt in zip(path[:-1], path[1:]):
        child = [] if isinstance(nxt, int) else {}
        if isinstance(key, int):
            if key == len(tree):
                tree.append(child)
            tree = tree[key]
        else:
            tree = tree.setdefault(key, child)
    if isinstance(path[-1], int) and path[-1] == len(tree):
        tree.append(leaf)
    else:
        tree[path[-1]] = leaf


def _get(tree, path: list):
    for key in path:
        tree = tree[key]
    return tree


def _split(name: str) -> tuple[list, int | None]:
    """``layers.3.in_proj.w`` -> (["layers", "in_proj", "w"], 3);
    ``tail.1.ln1.scale`` -> (["tail", 1, "ln1", "scale"], None);
    ``ln_f.scale`` -> (["ln_f", "scale"], None)."""
    parts = name.split(".")
    if parts[0] in STACKS:
        return [parts[0], *parts[2:]], int(parts[1])
    if parts[0] in LISTS:
        return [parts[0], int(parts[1]), *parts[2:]], None
    return parts, None


def from_jax(tree: dict, cfg: ArchConfig, *, device=None,
             dtype: torch.dtype | None = None, trainable: bool = False) -> nn.Module:
    """``tree``: the reference's ``init_lm`` output for ``cfg``'s family
    as numpy leaves (``jax.tree.map(np.asarray, params)``), or
    ``stacked_tree``'s output. Returns the family's model on ``device``
    holding exactly those values (cast to ``dtype`` when given); its
    parameters require grad when ``trainable``."""
    model = get_model(cfg).init(cfg, None, device=device)
    state = {}
    for path, leaf in tree_paths(tree).items():
        head, _, rest = path.partition(".")
        if head in STACKS:
            for i in range(leaf.shape[0]):
                state[f"{head}.{i}.{rest}"] = to_tensor(leaf[i], model.device, dtype)
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
    for name in LISTS:  # an empty list keeps its place in the tree
        if isinstance(getattr(model, name, None), nn.ModuleList):
            tree.setdefault(name, [])
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


def param_specs(model: nn.Module, specs: dict) -> dict:
    """{parameter name: P} of ``model`` from the reference's stacked spec
    tree ``specs`` (its family's ``lm_specs``): a layer parameter takes
    its stacked leaf's spec without the leading layer entry."""
    out = {}
    for name, _ in model.named_parameters():
        path, layer = _split(name)
        spec = _get(specs, path)
        out[name] = spec if layer is None else type(spec)(*spec[1:])
    return out


@torch.no_grad()
def distribute_params(model: nn.Module, specs: dict, mesh, src_rank: int | None = None) -> None:
    """Replace each parameter of ``model`` by a DTensor laid out by its
    spec on ``mesh`` (``shardings.distribute``), keeping requires_grad."""
    from repro_torch.models.shardings import distribute

    for name, spec in param_specs(model, specs).items():
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        old = getattr(mod, attr)
        new = distribute(old.detach(), spec, mesh, src_rank)
        setattr(mod, attr, nn.Parameter(new, requires_grad=old.requires_grad))
