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
``adamw_update_`` computes the same values with the state donated, as
the reference's jitted step donates it: it overwrites the parameters,
m and v in place, a chunk of each leaf at a time, so that a step never
holds a second copy of the optimizer state nor more than one chunk's
f32 temporaries (by their byte count, the pure form's copies and
temporaries at starcoder2-15b's width, 8 layers, pass the card's 80 GB).
The train step uses it and writes the new parameters back into the
layer modules.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.nn import functional as F

from repro_torch.models.shardings import P, is_dtensor
from repro_torch.models.stack import tree_leaves, tree_map


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


# elements of a leaf that ``adamw_update_`` updates at a time
CHUNK = 1 << 24


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


def opt_state_shape(params: dict, c: OptConfig) -> dict:
    """``init_opt_state`` on ``meta`` tensors: the state's shapes and
    dtypes with no allocation. ``params`` a stacked tree of tensors (or
    anything with ``.shape``)."""
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"), params)
    return init_opt_state(meta, c)


def opt_specs(param_specs: dict, c: OptConfig) -> dict:
    """Optimizer-state specs mirroring the param specs; the quantized v
    leaves (blocks, block) / (blocks, 1) replicate, as in the reference."""
    m = tree_map(lambda s: s, param_specs)
    if c.quantize_v:
        v = tree_map(lambda s: (P(None, None), P(None, None)), param_specs)
    else:
        v = tree_map(lambda s: s, param_specs)
    return {"m": m, "v": v, "count": P()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, f32. On DTensor leaves
    the sums are DTensor reductions (a replicated leaf counted once) and
    the result is the global value on every rank, as a plain tensor."""
    gn = torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                        for x in tree_leaves(tree)))
    return gn.full_tensor() if is_dtensor(gn) else gn


def _step_scalars(grads: dict, state: dict, c: OptConfig):
    """(count, grad norm, clip scale, lr, bias corrections 1 and 2); on a
    mesh ``count`` is a replicated DTensor and the rest plain tensors."""
    count = state["count"] + 1
    gn = global_norm(grads)
    local = count.to_local() if is_dtensor(count) else count
    scale = torch.clamp(c.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    bc1 = 1 - c.b1 ** local.to(torch.float32)
    bc2 = 1 - c.b2 ** local.to(torch.float32)
    return count, gn, scale, schedule(c, local), bc1, bc2


def _adamw(p, g, m, vf, decays: bool, c: OptConfig, scale, lr, bc1, bc2):
    """One leaf's (or one chunk of it) new (p, m, v), v in float32;
    ``decays``: the leaf has rank >= 2."""
    g = g.to(torch.float32) * scale
    v2 = _new_v(g, vf, c)
    p2, m2 = _adamw_pm(p, g, m, v2, decays, c, lr, bc1, bc2)
    return p2, m2, v2


def _new_v(g, vf, c: OptConfig):
    """The new second moment from the clipped f32 gradient ``g`` and the
    old v ``vf`` (float32)."""
    return c.b2 * vf + (1 - c.b2) * torch.square(g)


def _adamw_pm(p, g, m, v2, decays: bool, c: OptConfig, lr, bc1, bc2):
    """``_adamw``'s new (p, m) from the clipped f32 gradient ``g`` and the
    new v ``v2``."""
    m2 = c.b1 * m + (1 - c.b1) * g
    mhat = m2 / bc1
    vhat = v2 / bc2
    step = mhat / (torch.sqrt(vhat) + c.eps)
    decay = c.weight_decay * p.to(torch.float32) if decays else 0.0
    p2 = (p.to(torch.float32) - lr * (step + decay)).to(p.dtype)
    return p2, m2


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, c: OptConfig):
    """Stacked trees in, (new_params, new_state, metrics) out; new
    parameters keep each leaf's dtype."""
    count, gn, scale, lr, bc1, bc2 = _step_scalars(grads, state, c)

    def upd(p, g, m, v):
        vf = _dequantize(*v, p.shape, c.qblock) if c.quantize_v else v
        p2, m2, v2 = _adamw(p, g, m, vf, p.dim() >= 2, c, scale, lr, bc1, bc2)
        return p2, m2, (_quantize(v2, c.qblock) if c.quantize_v else v2)

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "count": count}, {"grad_norm": gn, "lr": lr}


@torch.no_grad()
def adamw_update_(grads: dict, state: dict, params: dict, c: OptConfig):
    """``adamw_update`` with ``params`` and ``state`` donated: each
    parameter leaf, m and v (the int8 q and scales too) is overwritten
    with its new value, ``CHUNK`` elements at a time (rounded to whole
    ``qblock`` blocks, so no block spans two chunks). Elementwise, so
    the values are ``adamw_update``'s bit for bit. Every leaf must be
    contiguous. Returns (new_state, metrics); ``params`` holds the new
    parameters.

    On a mesh (DTensor leaves) each rank updates p and m on its own
    shard. With ``quantize_v`` the (q, scale) leaves replicate
    (``opt_specs``, as the reference's): every rank forms each leaf's
    whole gradient (``full_tensor``, the one collective a replicated v
    implies), updates the whole v from it chunk by chunk as on one
    device, so every rank holds the same bytes, and takes its shard's
    slice of the new v (a local slice, no communication). That costs a
    rank, for one leaf at a time, its whole gradient and one whole f32
    leaf (the new v): at falcon-mamba-7b's 65,024 x 4,096 embedding,
    1.07 GB of f32 beside 0.53 GB of bf16 gradient."""
    count, gn, scale, lr, bc1, bc2 = _step_scalars(grads, state, c)
    chunk = max(c.qblock, CHUNK // c.qblock * c.qblock)

    def pieces(n):
        """(elements, v blocks) of each chunk of a flat leaf of n elements."""
        return [(slice(i, i + chunk), slice(i // c.qblock, -(-min(i + chunk, n) // c.qblock)))
                for i in range(0, n, chunk)]

    def requantize_(v2, v, blocks):
        q, sc = _quantize(v2, c.qblock)
        v[0][blocks].copy_(q)
        v[1][blocks].copy_(sc)

    def whole_v_(g, v):
        """A replicated int8 v's new value from the leaf's whole gradient:
        q and scales overwritten, the new v returned in f32."""
        gf = g.reshape(-1)
        v2 = torch.empty(gf.shape, dtype=torch.float32, device=gf.device)
        for sl, blocks in pieces(gf.numel()):
            vf = _dequantize(v[0][blocks], v[1][blocks], v2[sl].shape, c.qblock)
            v2[sl] = _new_v(gf[sl].to(torch.float32) * scale, vf, c)
            requantize_(v2[sl], v, blocks)
        return v2.view(g.shape)

    def upd(p, g, m, v):
        decays, v2 = p.dim() >= 2, None
        if is_dtensor(p):
            if c.quantize_v:
                g = g.full_tensor()
                v2 = _shard_of(whole_v_(g, tuple(t.to_local() for t in v)), p).reshape(-1)
                g = _shard_of(g, p)
            else:
                if tuple(g.placements) != tuple(p.placements):
                    g = g.redistribute(p.device_mesh, p.placements)
                g, v = g.to_local(), v.to_local()
            p, m = p.to_local(), m.to_local()
        pf, gf, mf = p.view(-1), g.reshape(-1), m.view(-1)
        for sl, blocks in pieces(pf.numel()):
            gs = gf[sl].to(torch.float32) * scale
            if v2 is not None:  # formed whole above
                new = v2[sl]
            elif c.quantize_v:
                new = _new_v(gs, _dequantize(v[0][blocks], v[1][blocks], pf[sl].shape,
                                             c.qblock), c)
                requantize_(new, v, blocks)
            else:
                new = _new_v(gs, v.view(-1)[sl], c)
                v.view(-1)[sl].copy_(new)
            p2, m2 = _adamw_pm(pf[sl], gs, mf[sl], new, decays, c, lr, bc1, bc2)
            pf[sl].copy_(p2)
            mf[sl].copy_(m2)

    tree_map(upd, params, grads, state["m"], state["v"])
    return ({"m": state["m"], "v": state["v"], "count": count},
            {"grad_norm": gn, "lr": lr})


def _shard_of(full: torch.Tensor, like) -> torch.Tensor:
    """The local shard, in DTensor ``like``'s layout, of ``full`` (the same
    global value on every rank): a slice, no communication."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    rep = DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return rep.redistribute(mesh, like.placements).to_local()
