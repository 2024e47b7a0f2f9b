"""The JAX package's parameter tree, as numpy arrays, into the port's
``MambaLM``.

The reference stacks each layer leaf on a leading ``L`` axis; here the
axis is sliced into ``layers.<i>``, and a tree path ``a/b/c`` becomes the
state dict key ``a.b.c``. Leaves keep their dtype unless ``dtype`` names
one for every floating leaf. A bfloat16 leaf arrives from JAX as an
``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` refuses: it is
recognised by its dtype's name, widened to float32 (exact) and narrowed
to ``torch.bfloat16`` (exact again). The port does not import
``ml_dtypes``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.mamba import MambaLM


def to_tensor(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, path + ".")
        else:
            yield path, val


def mamba_from_jax(tree: dict, cfg: ArchConfig, *, device=None,
                   dtype: torch.dtype | None = None) -> MambaLM:
    """``tree``: the reference's ``mamba.init_lm`` output as numpy leaves
    (``jax.tree.map(np.asarray, params)``). Returns a ``MambaLM`` on
    ``device`` holding exactly those values (cast to ``dtype`` when
    given)."""
    model = MambaLM(cfg, device=device, seed=None)
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
        p.requires_grad_(False)
    return model
