"""Shared model primitives: norms, RoPE, GQA attention (train / prefill /
decode), MLPs, embeddings and the loss.

Parameters are ``nn.Module``s whose attributes carry the JAX package's
names (``norm.scale``, ``in_proj.w``), so a state dict key is the
reference's tree path. Layouts are the reference's: a dense weight is
``(d_in, d_out)`` and is applied as ``x @ w``; an embedding is
``(vocab, d_model)``. Weights are bf16 by default, norm scales f32; the
arithmetic follows the reference's dtype promotion (a bf16 activation
plus an f32 bias is f32; a bf16 activation times an f32 weight is an f32
product; ``dense`` rounds the bias to the product's dtype first, as the
reference's ``b.astype(y.dtype)`` does).

Attention is the reference's, op for op (src/repro/models/layers.py):
the train / prefill path walks ``fit_chunk(S, attn_chunk)`` query chunks
and materializes each chunk's (B, H, chunk, S) float32 scores, masked
with -1e30 where the causal (and sliding-window) mask is false; the
decode path attends one token over a ring-buffer cache with the KV
heads never expanded (``_grouped_attend``). The products are plain
``torch.einsum`` / ``@`` in the operands' dtype, with no library
attention: ``einsum_f32`` follows the reference's non-TPU branch (the
product in the operands' dtype, then upcast), which on the card is a
bf16 product accumulated in float32 and rounded once. The reference's
sequence-sharded decode (a ``shard_map`` flash combine) is ``local_map``
over DTensor caches with explicit ``all_reduce``s. ``cross_attention``
(the encdec family) attends queries over a precomputed memory, unmasked
and unchunked, as the reference does. ``constrain`` pins activations at
the reference's sites; it is the identity unless they are DTensors.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.shardings import (SINGLE, MeshAxes, P, ServePlan, constrain, distribute,
                                          gather_inner, has_mesh, is_dtensor, pin_grad,
                                          placements)


class TensorSpec(NamedTuple):
    """Shape and dtype of one cache leaf (the reference's ShapeDtypeStruct)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def serving(fn):
    """The decorator of every family's ``prefill`` and ``decode_step``:
    ``fn`` under ``inference_mode`` with no mesh in context (the
    single-card serve loops), under ``no_grad`` with one (DTensor
    refuses inference tensors). The values are the same either way."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.no_grad() if has_mesh() else torch.inference_mode():
            return fn(*args, **kwargs)

    return run


def param(t: torch.Tensor) -> nn.Parameter:
    """A serving parameter: no gradient."""
    return nn.Parameter(t, requires_grad=False)


def draw(gen: torch.Generator | None, shape, scale: float, dtype, device) -> torch.Tensor:
    """Standard normal * ``scale`` drawn in f32 on ``device`` from
    ``gen``, cast to ``dtype``; left uninitialised when ``gen`` is None
    (the tensor is about to be replaced by converted weights)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    out = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (out * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    v = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(v + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class Norm(nn.Module):
    """``scale`` (and ``bias`` for layernorm), f32."""

    def __init__(self, cfg: ArchConfig, d: int, device):
        super().__init__()
        self.scale = param(torch.ones((d,), dtype=torch.float32, device=device))
        if cfg.norm == "layernorm":
            self.bias = param(torch.zeros((d,), dtype=torch.float32, device=device))


def norm(x: torch.Tensor, p: Norm, cfg: ArchConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p.scale, p.bias, cfg.norm_eps)
    return rmsnorm(x, p.scale, cfg.norm_eps)


def init_norm(cfg: ArchConfig, d: int, device) -> Norm:
    return Norm(cfg, d, device)


# ---------------------------------------------------------------------------
# dense projections
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """``w`` (d_in, d_out), and an f32 bias ``b`` when asked."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = param(w)
        if b is not None:
            self.b = param(b)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    x = gather_inner(x)
    if is_dtensor(x) and not x.is_contiguous():
        # matmul folds (B, S, d) into (B * S, d) only when the leading
        # strides allow a view; else it expands w to (B, d, d), which
        # DTensor materializes on every rank
        x = x.contiguous()
    y = pin_grad(x @ w if x.dtype == w.dtype else torch.matmul(*_promote(x, w)))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def init_dense(gen, d_in: int, d_out: int, bias: bool, dtype=torch.bfloat16,
               device=None) -> Dense:
    w = draw(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype, device)
    b = torch.zeros((d_out,), dtype=torch.float32, device=device) if bias else None
    return Dense(w, b)


def _promote(*ts: torch.Tensor) -> list[torch.Tensor]:
    """The operands in their common dtype (bf16 with f32 gives f32, as
    in JAX): ``torch.einsum`` takes no mixed dtypes."""
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in ts]


def einsum_f32(subscripts: str, *ops: torch.Tensor) -> torch.Tensor:
    """The reference's non-TPU branch: the product in the (promoted)
    operands' dtype, then upcast to float32."""
    return torch.einsum(subscripts, *_promote(*ops)).to(torch.float32)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x: (B, S, H, D) with D even;
    positions: (S,) or (B, S); angles in float32."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(x.device, torch.float32)[..., None] * freqs  # (S | B S, half)
    ang = ang[None, :, None, :] if positions.dim() == 1 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


class Attn(nn.Module):
    """``wq``, ``wk``, ``wv`` (biased when ``cfg.qkv_bias``) and ``wo``."""

    def __init__(self, cfg: ArchConfig, gen, dtype, device):
        super().__init__()
        self.wq = init_dense(gen, cfg.d_model, cfg.q_dim, cfg.qkv_bias, dtype, device)
        self.wk = init_dense(gen, cfg.d_model, cfg.kv_dim, cfg.qkv_bias, dtype, device)
        self.wv = init_dense(gen, cfg.d_model, cfg.kv_dim, cfg.qkv_bias, dtype, device)
        self.wo = init_dense(gen, cfg.q_dim, cfg.d_model, False, dtype, device)


def init_attn(gen, cfg: ArchConfig, dtype=torch.bfloat16, device=None) -> Attn:
    return Attn(cfg, gen, dtype, device)


def _dense_of(x: torch.Tensor, d: Dense) -> torch.Tensor:
    return dense(x, d.w, getattr(d, "b", None))


def _split_heads(t: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(B, S, n * d) -> (B, S, n, d). A DTensor whose last dim is split
    over more ranks than divide ``n`` (4 KV heads on 8 tp ranks) is
    gathered on it first: a shard must hold whole heads."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        mesh, last = t.device_mesh, t.dim() - 1
        on_last = [i for i, q in enumerate(t.placements)
                   if isinstance(q, Shard) and q.dim % t.dim() == last]
        ways = 1
        for i in on_last:
            ways *= mesh.size(i)
        if n % ways:
            t = t.redistribute(mesh, [Replicate() if i in on_last else q
                                      for i, q in enumerate(t.placements)])
    return t.reshape(*t.shape[:-1], n, d)


def qkv_proj(x: torch.Tensor, p: Attn, cfg: ArchConfig, ax: MeshAxes, positions):
    """(B, S, d_model) -> q (B, S, H, hd), k and v (B, S, KV, hd); RoPE
    on q and k when ``positions`` is given."""
    q = _split_heads(_dense_of(x, p.wq), cfg.num_heads, cfg.head_dim)
    k = _split_heads(_dense_of(x, p.wk), cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(_dense_of(x, p.wv), cfg.num_kv_heads, cfg.head_dim)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def expand_kv(k: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(.., KV, D) -> (.., H, D), each kv head repeated over its q group
    (``jnp.repeat``: kv head j serves q heads j*g .. j*g + g - 1)."""
    g = cfg.num_heads // cfg.num_kv_heads
    if g == 1:
        return k
    return torch.repeat_interleave(k, g, dim=-2)


def fit_chunk(s: int, want: int) -> int:
    """Largest chunk <= want that divides s."""
    c = max(1, min(want, s))
    while s % c:
        c -= 1
    return c


def _causal_window_mask(pos_q: torch.Tensor, pos_k: torch.Tensor, window) -> torch.Tensor:
    m = pos_q[:, None] >= pos_k[None, :]
    if window is not None:
        m &= pos_q[:, None] - pos_k[None, :] < window
    return m


def _attend_chunk(qc, k, v, inv: float, mask=None) -> torch.Tensor:
    """One query chunk: f32 scores (B, H, chunk, S), masked with -1e30
    where ``mask`` is false, softmax, cast to q's dtype, then the value
    product. The in-place steps change no value."""
    scores = torch.einsum("bqhd,bthd->bhqt", *_promote(qc, k)).to(torch.float32).mul_(inv)
    if mask is not None:
        scores.masked_fill_(~mask, -1e30)
    w = torch.softmax(scores, dim=-1).to(qc.dtype)
    del scores
    return torch.einsum("bhqt,bthd->bqhd", *_promote(w, v))


def _per_head_shard(fn, ax: MeshAxes, q, k, v):
    """``fn(q, k, v) -> (B, S, H * D)``, attention over (B, S, H, D)
    operands, independent for each (batch row, head). On DTensors each
    rank runs ``fn`` on its (dp rows, tp heads) shard (``local_map``),
    the layout the reference pins with ``constrain``; DTensor's einsum
    would flatten (batch, heads) with the heads sharded, which torch 2.11
    refuses."""
    if not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    mesh, tp = q.device_mesh, ax.tp_if(q.shape[2])
    heads = list(placements(P(ax.dp, None, tp, None), mesh))
    return local_map(fn, out_placements=list(placements(P(ax.dp, None, tp), mesh)),
                     in_placements=(heads, heads, heads), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def attention_core_train(q, k, v, cfg: ArchConfig, ax: MeshAxes, base_pos: int = 0):
    """Chunked causal attention. q, k, v: (B, S, H, D) (kv already
    expanded). A loop over ``fit_chunk(S, attn_chunk)`` query chunks,
    each chunk's scores (B, H, chunk, S) float32. Returns (B, S, H * D)."""

    def core(q, k, v):
        b, s, h, d = q.shape
        chunk = fit_chunk(s, cfg.attn_chunk)
        inv = 1.0 / math.sqrt(d)
        pos_k = base_pos + torch.arange(s, device=q.device)
        outs = []
        for c0 in range(0, s, chunk):
            mask = _causal_window_mask(pos_k[c0 : c0 + chunk], pos_k, cfg.sliding_window)
            outs.append(_attend_chunk(q[:, c0 : c0 + chunk], k, v, inv, mask[None, None]))
        return torch.cat(outs, dim=1).reshape(b, s, h * d)

    return _per_head_shard(core, ax, q, k, v)


def _attention_full_bidir(q, k, v, cfg: ArchConfig, ax: MeshAxes = SINGLE):
    """Unmasked attention in the same query chunks."""

    def core(q, k, v):
        b, s, h, d = q.shape
        chunk = fit_chunk(s, cfg.attn_chunk)
        inv = 1.0 / math.sqrt(d)
        outs = [_attend_chunk(q[:, c0 : c0 + chunk], k, v, inv) for c0 in range(0, s, chunk)]
        return torch.cat(outs, dim=1).reshape(b, s, h * d)

    return _per_head_shard(core, ax, q, k, v)


def attention_train(x, p: Attn, cfg: ArchConfig, ax: MeshAxes, positions=None,
                    bidirectional: bool = False):
    """Self-attention over a whole sequence: projections, RoPE, the kv
    heads expanded, chunked attention (causal, or unmasked when
    ``bidirectional``), the output projection."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = qkv_proj(x, p, cfg, ax,
                       positions if (cfg.use_rope and cfg.head_dim % 2 == 0) else None)
    k, v = expand_kv(k, cfg), expand_kv(v, cfg)
    heads = P(ax.dp, None, ax.tp_if(cfg.num_heads), None)
    q, k, v = constrain(q, heads), constrain(k, heads), constrain(v, heads)
    if bidirectional:
        o = _attention_full_bidir(q, k, v, cfg, ax)
    else:
        o = attention_core_train(q, k, v, cfg, ax)
    return _dense_of(o, p.wo)


def cross_attention(x, mem_k, mem_v, p: Attn, cfg: ArchConfig, ax: MeshAxes):
    """x: (B, S, D) queries; mem_k / mem_v: (B, T, H, hd) precomputed.
    f32 scores over every memory position (no mask, no chunks), softmax,
    the weights cast to x's dtype, then the value product."""
    b, s, _ = x.shape
    q = _dense_of(x, p.wq).reshape(b, s, cfg.num_heads, cfg.head_dim)

    def core(q, mem_k, mem_v):
        scores = torch.einsum("bqhd,bthd->bhqt", *_promote(q, mem_k)).to(torch.float32)
        scores.mul_(1.0 / math.sqrt(cfg.head_dim))
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        del scores
        o = torch.einsum("bhqt,bthd->bqhd", *_promote(w, mem_v))
        return o.reshape(o.shape[0], s, -1)

    return _dense_of(_per_head_shard(core, ax, q, mem_k, mem_v), p.wo)


# -- decode (KV cache) --------------------------------------------------------


def _ring_valid(pos, smax: int, window: int | None, device=None) -> torch.Tensor:
    """Validity of each slot of a ring-buffer cache at ``pos``. Slot i
    holds absolute position ``pos - ((pos - i) mod smax)`` (the most
    recent write to it); negative means never written."""
    tpos = torch.arange(smax, device=device)
    abs_pos = pos - torch.remainder(pos - tpos, smax)
    valid = abs_pos >= 0
    if window is not None:
        valid &= (pos - abs_pos) < window
    return valid


def _grouped_attend(q, ck, cv, cfg: ArchConfig, valid):
    """Grouped-query attention of one token over a cache, the KV heads
    never expanded. q: (B, 1, H, hd); ck/cv: (B, T, KV, hd); valid: (T,)
    bool. Returns f32 partials o (B, KV, G, 1, hd), m and l (B, KV, G, 1)."""
    b, _, h, d = q.shape
    kv = ck.shape[2]
    qg = q.reshape(b, 1, kv, h // kv, d)
    scores = einsum_f32("bqkgd,btkd->bkgqt", qg, ck) * (1.0 / math.sqrt(d))
    scores.masked_fill_(~valid, -1e30)
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None])
    l = e.sum(dim=-1)
    o = einsum_f32("bkgqt,btkd->bkgqd", e.to(cv.dtype), cv)
    return o, m, l


def attention_decode_general(x1, cache_k, cache_v, p: Attn, cfg: ArchConfig, ax: MeshAxes,
                             pos: int, plan: ServePlan):
    """One-token decode against a KV ring-buffer cache (B, T, KV, hd):
    the token's k and v written at slot ``pos % T`` of new caches (the
    inputs are left as they were), then grouped attention over the slots
    ``_ring_valid`` admits. Returns (out (B, 1, d_model), cache_k,
    cache_v). A sequence-sharded plan (``plan.seq_axes``) takes the
    flash-combine branch (``_decode_seq_sharded``)."""
    b = x1.shape[0]
    smax = cache_k.shape[1]
    q, k1, v1 = qkv_proj(x1, p, cfg, ax, None)
    if cfg.use_rope and cfg.head_dim % 2 == 0:
        at = torch.full((1,), pos, device=x1.device)
        q = rope(q, at, cfg.rope_theta)
        k1 = rope(k1, at, cfg.rope_theta)
    if plan.seq_axes:
        o, cache_k, cache_v = _decode_seq_sharded(q, k1, v1, cache_k, cache_v, cfg, pos, plan,
                                                  x1.dtype)
        if not is_dtensor(x1) and is_dtensor(o):
            o = o.full_tensor()
        return _dense_of(o, p.wo), cache_k, cache_v
    slot = pos % smax
    cache_k, cache_v = cache_k.clone(), cache_v.clone()
    cache_k[:, slot] = k1[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v1[:, 0].to(cache_v.dtype)
    bspec = plan.batch_axes or None
    cache_k = constrain(cache_k, P(bspec, None, plan.kv_axes, None))
    cache_v = constrain(cache_v, P(bspec, None, plan.kv_axes, None))
    valid = _ring_valid(pos, smax, cfg.sliding_window, x1.device)

    def attend(q, ck, cv):
        o, _m, l = _grouped_attend(q, ck, cv, cfg, valid)
        o = (o / l[..., None]).to(x1.dtype)
        return o.permute(0, 3, 1, 2, 4).reshape(q.shape[0], 1, -1)

    if is_dtensor(cache_k):  # each rank on its (batch rows, KV heads) shard
        from torch.distributed.tensor.experimental import local_map

        mesh = cache_k.device_mesh
        heads = list(placements(P(bspec, None, plan.kv_axes, None), mesh))
        o = local_map(attend, out_placements=list(placements(P(bspec, None, plan.kv_axes),
                                                             mesh)),
                      in_placements=(heads, heads, heads), device_mesh=mesh,
                      redistribute_inputs=True)(q, cache_k, cache_v)
    else:
        o = attend(q, cache_k, cache_v)
    return _dense_of(o, p.wo), cache_k, cache_v


def _decode_seq_sharded(q, k1, v1, cache_k, cache_v, cfg: ArchConfig, pos: int,
                        plan: ServePlan, dtype):
    """The reference's ``shard_map`` flash combine over a cache whose
    sequence dim is sharded on ``plan.seq_axes`` (and batch on
    ``plan.batch_axes``): the caches are DTensors on their mesh. Each
    rank attends over its T / n slots; the rank owning slot ``pos % T``
    writes the token's k and v; then ``all_reduce(MAX)`` of m and
    ``all_reduce(SUM)`` of the rescaled l and o, axis by axis over the
    seq axes (both axes: the whole mesh). A rank's shard index is its
    mesh coordinates, last axis minor, as DTensor orders a dim sharded
    on two mesh dims. Returns (o (B, 1, q_dim) DTensor, cache_k, cache_v)."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import local_map

    if not is_dtensor(cache_k):
        raise TypeError("a sequence-sharded plan takes the caches as DTensors on their mesh")
    mesh = cache_k.device_mesh
    names = list(mesh.mesh_dim_names)
    seq_axes = plan.seq_axes
    bspec = plan.batch_axes or None
    smax = cache_k.shape[1]
    qspec = P(bspec, None, None, None)
    seq_spec = P(bspec, seq_axes, None, None)
    q, k1, v1 = (constrain(t, qspec) if is_dtensor(t) else distribute(t, qspec, mesh)
                 for t in (q, k1, v1))
    cache_k, cache_v = constrain(cache_k, seq_spec), constrain(cache_v, seq_spec)

    def local(q, k1, v1, ck, cv):
        sloc = ck.shape[1]
        idx, mul = 0, 1
        for a in reversed(seq_axes):
            idx += mesh.get_local_rank(a) * mul
            mul *= mesh.size(names.index(a))
        offset = idx * sloc
        slot = pos % smax
        ck, cv = ck.clone(), cv.clone()
        if offset <= slot < offset + sloc:
            ck[:, slot - offset] = k1[:, 0].to(ck.dtype)
            cv[:, slot - offset] = v1[:, 0].to(cv.dtype)
        tpos = offset + torch.arange(sloc, device=ck.device)
        abs_pos = pos - torch.remainder(pos - tpos, smax)
        valid = abs_pos >= 0
        if cfg.sliding_window is not None:
            valid &= (pos - abs_pos) < cfg.sliding_window
        o_loc, m_loc, l_loc = _grouped_attend(q, ck, cv, cfg, valid)
        m = m_loc.clone()
        for a in seq_axes:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
        corr = torch.exp(m_loc - m)
        l, o = l_loc * corr, o_loc * corr[..., None]
        for a in seq_axes:
            dist.all_reduce(l, group=mesh.get_group(a))
            dist.all_reduce(o, group=mesh.get_group(a))
        o = (o / l[..., None]).to(dtype)  # (B, KV, G, 1, hd)
        return o.permute(0, 3, 1, 2, 4).reshape(q.shape[0], 1, cfg.q_dim), ck, cv

    pl = lambda spec: list(placements(spec, mesh))
    return local_map(local, out_placements=(pl(P(bspec, None, None)), pl(seq_spec),
                                            pl(seq_spec)),
                     in_placements=(pl(qspec), pl(qspec), pl(qspec), pl(seq_spec),
                                    pl(seq_spec)),
                     device_mesh=mesh)(q, k1, v1, cache_k, cache_v)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class Mlp(nn.Module):
    """``wi``, ``wd`` with biases (``act == "gelu"``, the classic
    two-matrix MLP), else the gated ``wg``, ``wu``, ``wd`` without."""

    def __init__(self, cfg: ArchConfig, gen, d_ff: int, dtype, device):
        super().__init__()
        if cfg.act == "gelu":
            self.wi = init_dense(gen, cfg.d_model, d_ff, True, dtype, device)
            self.wd = init_dense(gen, d_ff, cfg.d_model, True, dtype, device)
        else:
            self.wg = init_dense(gen, cfg.d_model, d_ff, False, dtype, device)
            self.wu = init_dense(gen, cfg.d_model, d_ff, False, dtype, device)
            self.wd = init_dense(gen, d_ff, cfg.d_model, False, dtype, device)


def init_mlp(gen, cfg: ArchConfig, d_ff: int | None = None, dtype=torch.bfloat16,
             device=None) -> Mlp:
    return Mlp(cfg, gen, d_ff or cfg.d_ff, dtype, device)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(x: torch.Tensor, p: Mlp, cfg: ArchConfig, ax: MeshAxes) -> torch.Tensor:
    if cfg.act == "gelu":  # classic 2-matrix MLP (starcoder2, seamless)
        h = _gelu(_dense_of(x, p.wi))
        h = constrain(h, P(ax.dp, None, ax.tp_if(cfg.d_ff)))
        return _dense_of(h, p.wd)
    gate_act = _gelu if cfg.act == "gelu_gated" else F.silu
    h = gate_act(dense(x, p.wg.w)) * dense(x, p.wu.w)
    h = constrain(h, P(ax.dp, None, ax.tp_if(cfg.d_ff)))
    return _dense_of(h, p.wd)


# ---------------------------------------------------------------------------
# embeddings & loss
# ---------------------------------------------------------------------------


def init_embed(gen, cfg: ArchConfig, dtype=torch.bfloat16, device=None) -> nn.Parameter:
    return param(draw(gen, (cfg.vocab_size, cfg.d_model), 0.02, dtype, device))


def embed_tokens(embed: torch.Tensor, tokens, ax: MeshAxes = SINGLE) -> torch.Tensor:
    """tokens (B, S) ints (a tensor, or a numpy array moved to the
    embedding's device) -> (B, S, d_model) in the embedding's dtype."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens, dtype=np.int64))
    # a gathered table: DTensor's vocab-parallel lookup (a masked partial
    # sum) fails to reduce once the tokens are batch-sharded as well
    x = nn.functional.embedding(tokens.to(embed.device, torch.long), constrain(embed, P()))
    return constrain(x, P(ax.dp, None, None))


def unembed(x: torch.Tensor, embed_or_head: torch.Tensor, vocab: int,
            ax: MeshAxes = SINGLE) -> torch.Tensor:
    """Logits in x's dtype; a (vocab, d) weight is the tied embedding."""
    w = embed_or_head.to(x.dtype)
    logits = pin_grad(gather_inner(x) @ (w.T if w.shape[0] == vocab else w))
    return constrain(logits, P(ax.dp, None, ax.tp_if(vocab)))


def xent_loss(logits: torch.Tensor, labels: torch.Tensor, ax: MeshAxes) -> torch.Tensor:
    """Mean cross-entropy of (.., V) logits against integer labels, f32."""
    lf = logits.to(torch.float32)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.mean(torch.logsumexp(lf, dim=-1) - ll)
