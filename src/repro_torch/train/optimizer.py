"""AdamW with global-norm clipping, cosine schedule, and an optional
blockwise-int8 quantized second moment (8-bit-optimizer-style memory
compression: int8 + one f32 scale per block cuts the f32 v-buffer
~3.9x).

The state lives in the reference's *stacked* layout
(src/repro/train/optimizer.py): one tensor per leaf of the reference's
parameter tree, every layer leaf with a leading ``L`` axis, built by
``models.convert.stacked_tree``. That layout decides two things the
per-layer modules would get wrong: weight decay applies to a leaf of
rank >= 2, which is every stacked layer leaf (per-layer vectors such as
``norm.scale``, ``conv_b``, ``dt_proj.b`` and ``d_skip`` included) and
the embedding, but not ``ln_f.scale``; and the quantized v cuts the
flattened stacked leaf into ``qblock``-element blocks, so one block may
span two layers. ``adamw_update`` is a pure function of stacked trees;
the train step writes its new parameters back into the layer modules.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.nn import functional as F


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantize_v: bool = False  # int8 blockwise second moment
    qblock: int = 256


def schedule(c: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine decay to ``min_lr_frac * lr``;
    ``step`` an integer tensor, the result f32 on its device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(c.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - c.warmup_steps) / max(c.decay_steps, 1), 0.0, 1.0)
    cos = c.min_lr_frac + (1 - c.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return c.lr * warm * cos


# -- int8 blockwise quantization ---------------------------------------------


def _quantize(x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (q (blocks, block) int8, scale (blocks, 1) f32)
    over the flattened x, zero-padded to whole blocks."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    # torch.round rounds half to even, as jnp.round does
    q = torch.round(blocks / torch.clamp(scale, min=1e-20)).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape, block: int) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


# -- state --------------------------------------------------------------------


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and of ``rest``, trees of
    the same structure); a (q, scale) tuple is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init_opt_state(params: dict, c: OptConfig) -> dict:
    """``params``: the stacked tree. m (and v) f32 zeros of each leaf's
    shape, on its device; v as (q, scale) when quantized."""

    def zeros_like_f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    m = tree_map(zeros_like_f32, params)
    if c.quantize_v:
        v = tree_map(lambda p: _quantize(zeros_like_f32(p), c.qblock), params)
    else:
        v = tree_map(zeros_like_f32, params)
    device = tree_leaves(params)[0].device
    return {"m": m, "v": v, "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, c: OptConfig):
    """Stacked trees in, (new_params, new_state, metrics) out; new
    parameters keep each leaf's dtype."""
    count = state["count"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(c.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    lr = schedule(c, count)
    bc1 = 1 - c.b1 ** count.to(torch.float32)
    bc2 = 1 - c.b2 ** count.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m2 = c.b1 * m + (1 - c.b1) * g
        vf = _dequantize(*v, p.shape, c.qblock) if c.quantize_v else v
        v2 = c.b2 * vf + (1 - c.b2) * torch.square(g)
        mhat = m2 / bc1
        vhat = v2 / bc2
        step = mhat / (torch.sqrt(vhat) + c.eps)
        decay = c.weight_decay * p.to(torch.float32) if p.dim() >= 2 else 0.0
        p2 = (p.to(torch.float32) - lr * (step + decay)).to(p.dtype)
        v_out = _quantize(v2, c.qblock) if c.quantize_v else v2
        return p2, m2, v_out

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "count": count}, {"grad_norm": gn, "lr": lr}
