"""Mixture-of-Experts FFN (src/repro/models/moe.py): the granite-moe and
olmoe families.

Top-k routing with per-sequence capacity groups and gather / scatter
dispatch, as in the reference: no (S, E, C) one-hot dispatch tensor,
but two row gathers and one scatter, O(S * k + E * C). The reference is
plain ``jnp`` (no ``pallas_call``), so this is plain torch: ``route``,
a cumulative-sum rank, a scatter, row gathers and three batched
einsums.

Three places where torch's primitives differ from JAX's, each kept to
the reference's result:

- ``jax.lax.top_k`` puts the lower-index element first among equals,
  and bf16 router logits tie often; ``torch.topk`` promises no order,
  so the top ``k`` come from a stable descending ``torch.sort``.
- The dispatch scatter drops a dropped choice's write (``mode="drop"``:
  its slot is out of range but for expert 0, whose slot is the
  sentinel column); ``scatter_`` would raise, so every dropped choice
  writes to the sentinel column, which is sliced off. Kept slots are
  unique, so no two writes meet there.
- ``take_along_axis`` broadcasts its index; ``torch.gather`` would need
  it expanded to the output's size (5.4 GB per layer at olmoe's 32k
  prefill), so the rows are gathered by advanced indexing on the token
  axis.

Expert placement on a mesh (``ep_axis``, ``expert_ff_axis``,
``moe_specs``) is the reference's: the expert dim on tp when it divides,
else each expert's FFN hidden dim on tp. On DTensors (``_moe_ffn_shards``)
each rank routes, builds its dispatch table and gathers its rows on its
own batch shard (``local_map``: the table is per sequence); the expert
counts and the probability sums of the aux loss come out as partial
sums over the dp axes. The
expert FFN runs per shard too, with its input, output and gradient
placements stated: experts on tp (``ep_axis``), or their hidden dim on
tp (``expert_ff_axis``: Megatron's pair of reductions inside the shard,
the down projection's output summed over tp forward, the input's
gradient summed backward), each weight's gradient a partial sum over
the dp axes.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.shardings import SINGLE, MeshAxes, P, constrain, is_dtensor


def ep_axis(cfg: ArchConfig, ax: MeshAxes):
    return ax.tp if (ax.tp and cfg.num_experts % ax.tp_size == 0) else None


def expert_ff_axis(cfg: ArchConfig, ax: MeshAxes):
    """TP inside each expert's FFN, only when experts are not EP-sharded."""
    if ep_axis(cfg, ax) is not None:
        return None
    return ax.tp_if(cfg.d_ff)


def moe_specs(cfg: ArchConfig, ax: MeshAxes) -> dict:
    ep = ep_axis(cfg, ax)
    ff = expert_ff_axis(cfg, ax)
    fs = ax.fsdp_if(cfg.d_model)
    return {
        "router": {"w": P(fs, None)},
        "wg": P(ep, fs, ff),
        "wu": P(ep, fs, ff),
        "wd": P(ep, ff, fs),
    }


class Moe(nn.Module):
    """``router.w`` (d, E) f32, ``wg`` and ``wu`` (E, d, f), ``wd`` (E, f, d)
    in the compute dtype."""

    def __init__(self, cfg: ArchConfig, gen, dtype, device):
        super().__init__()
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        scale_in, scale_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        self.router = L.Dense(L.draw(gen, (d, e), scale_in, torch.float32, device))
        self.wg = L.param(L.draw(gen, (e, d, f), scale_in, dtype, device))
        self.wu = L.param(L.draw(gen, (e, d, f), scale_in, dtype, device))
        self.wd = L.param(L.draw(gen, (e, f, d), scale_out, dtype, device))


def init_moe(gen, cfg: ArchConfig, dtype=torch.bfloat16, device=None) -> Moe:
    return Moe(cfg, gen, dtype, device)


def capacity(cfg: ArchConfig, s: int) -> int:
    """Per-sequence expert capacity (tokens/expert), padded to 8."""
    c = int(math.ceil(cfg.capacity_factor * cfg.experts_per_token * s / cfg.num_experts))
    return max(8, -(-c // 8) * 8)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest along the last axis, in
    descending order, the lower index first among equals."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_sums(x: torch.Tensor, router_w: torch.Tensor, cfg: ArchConfig):
    """x (B, S, D) -> (gates (B, S, kk) f32, expert idx (B, S, kk) int64,
    each expert's count of choices (E,) f32, each expert's router
    probability summed over (B, S) (E,) f32). The sums are those of the
    rows given: on a mesh, one batch shard's partial sums (``aux_loss``
    takes them either way)."""
    logits = L.einsum_f32("bsd,de->bse", x, router_w.to(x.dtype))
    top_vals, top_idx = top_k(logits, cfg.experts_per_token)
    gates = torch.softmax(top_vals, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    # integer sums, exact in f32, as the reference's one_hot sum is; a
    # scatter (not ``bincount``, whose output length depends on the
    # values) so that a ``meta`` tensor (the dry run) counts the same way
    flat = top_idx.reshape(-1)
    counts = torch.zeros(cfg.num_experts, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat)).to(torch.float32)
    return gates, top_idx, counts, probs.sum(dim=(0, 1))


def aux_loss(counts, prob_sum, tokens: int, cfg: ArchConfig):
    """The Switch-style load-balance aux loss E * sum_e(frac_tokens_e *
    mean_prob_e) from ``route_sums``' sums over ``tokens`` = B * S."""
    e, kk = cfg.num_experts, cfg.experts_per_token
    return e * torch.sum(counts / tokens / kk * (prob_sum / tokens))


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: ArchConfig):
    """x (B, S, D) -> (gates (B, S, kk) f32, expert idx (B, S, kk) int64,
    the aux loss, f32)."""
    gates, idx, counts, prob_sum = route_sums(x, router_w, cfg)
    return gates, idx, aux_loss(counts, prob_sum, x.shape[0] * x.shape[1], cfg)


def _dispatch(x, gates, idx, cfg: ArchConfig):
    """The dispatch of one batch (or batch shard): x (B, S, D), gates and
    idx (B, S, kk) -> (xe (B, E, cap, D) the tokens gathered per expert,
    slot (B, S * kk) each choice's column of the flattened (E * cap)
    expert rows, the sentinel E * cap where dropped, gk (B, S, kk) the
    gates of the kept choices in x's dtype)."""
    b, s, d = x.shape
    e, kk = cfg.num_experts, cfg.experts_per_token
    cap = capacity(cfg, s)

    # slot assignment: the rank of each (token, choice) within its expert,
    # choices flattened token-major so that earlier tokens win the slots;
    # the running count runs along the last, contiguous axis of (B, E,
    # S*kk): a scan along the middle axis of (B, S*kk, E) is slow on the
    # card (PERF.md, the moe prefill)
    fidx = idx.reshape(b, s * kk)
    hits = fidx[:, None, :] == torch.arange(e, device=x.device)[None, :, None]
    ranks = torch.cumsum(hits, dim=-1, dtype=torch.int32) - 1
    pos = torch.gather(ranks, 1, fidx[:, None, :])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, fidx * cap + pos, e * cap)  # dropped -> the sentinel column
    tok_of_choice = torch.arange(s, device=x.device).repeat_interleave(kk).expand(b, s * kk)
    dispatch = torch.full((b, e * cap + 1), s, dtype=torch.long, device=x.device)
    dispatch.scatter_(1, slot, tok_of_choice)  # sentinel = s, the zero pad row
    dispatch = dispatch[:, : e * cap].reshape(b, e, cap)

    # gather the tokens -> (B, E, cap, D)
    rows = torch.arange(b, device=x.device)
    xpad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    xe = xpad[rows[:, None, None], dispatch]
    return xe, slot, (gates * keep.reshape(b, s, kk)).to(x.dtype)


def _expert_ffn(xe, wg, wu, wd, cfg: ArchConfig, ax: MeshAxes = SINGLE):
    """The expert FFN, batched over E: xe (B, E, cap, D) -> (B, E, cap, D)."""
    ep, ff = ep_axis(cfg, ax), expert_ff_axis(cfg, ax)
    act = L._gelu if cfg.act.startswith("gelu") else F.silu
    h = act(torch.einsum("becd,edf->becf", xe, wg)) * torch.einsum("becd,edf->becf", xe, wu)
    h = constrain(h, P(ax.dp, ep, None, ff))
    return torch.einsum("becf,efd->becd", h, wd)


def _combine(ye, slot, gk):
    """Gather back each token's kk expert outputs and sum them by their
    gates: ye (B, E, cap, D), slot (B, S * kk), gk (B, S, kk) -> (B, S, D)."""
    b, e, cap, d = ye.shape
    s, kk = gk.shape[1], gk.shape[2]
    rows = torch.arange(b, device=ye.device)
    yflat = torch.cat([ye.reshape(b, e * cap, d), ye.new_zeros((b, 1, d))], dim=1)
    yk = yflat[rows[:, None], slot].reshape(b, s, kk, d)
    return torch.einsum("bskd,bsk->bsd", yk, gk)


def moe_ffn(x: torch.Tensor, p: Moe, cfg: ArchConfig, ax: MeshAxes = SINGLE):
    """Capacity-dropped top-k MoE. x (B, S, D) -> ((B, S, D), aux)."""
    if is_dtensor(x):
        return _moe_ffn_shards(x, p, cfg, ax)
    gates, idx, aux = route(x, p.router.w, cfg)  # (B, S, kk)
    xe, slot, gk = _dispatch(x, gates, idx, cfg)
    ye = _expert_ffn(xe, p.wg, p.wu, p.wd, cfg, ax)
    return _combine(ye, slot, gk), aux


class _SumForward(torch.autograd.Function):
    """All-reduce over ``group`` forward, the identity backward (the
    partial sums of a row-parallel product; what follows is replicated)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist

        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """The identity forward, all-reduce over ``group`` backward (the input
    of a column-parallel product: each rank's gradient covers its
    columns only)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _moe_ffn_shards(x, p: Moe, cfg: ArchConfig, ax: MeshAxes):
    """``moe_ffn`` on DTensors (see the module docstring): three
    ``local_map`` stages (route and dispatch, the expert FFN, combine)
    on each rank's batch rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    ep, ff = ep_axis(cfg, ax), expert_ff_axis(cfg, ax)
    dp = ax.dp_if(x.shape[0])

    def pl(batch=None, tp=None):
        """Per mesh dim: ``batch`` on the dp axes that shard the batch (a
        placement, or None for Replicate), ``tp`` on the tp axis,
        Replicate elsewhere."""
        return [(batch or Replicate()) if n in dp else
                (tp or Replicate()) if n == ax.tp else Replicate() for n in names]

    rows = pl(Shard(0))
    partial_dp = pl(Partial())

    def route_local(x, router_w):
        gates, idx, counts, prob_sum = route_sums(x, router_w, cfg)
        return (*_dispatch(x, gates, idx, cfg), counts, prob_sum)

    xe, slot, gk, counts, prob_sum = local_map(
        route_local, out_placements=(rows, rows, rows, partial_dp, partial_dp),
        in_placements=(rows, pl()), in_grad_placements=(rows, partial_dp),
        device_mesh=mesh, redistribute_inputs=True)(x, p.router.w)
    aux = aux_loss(counts, prob_sum, x.shape[0] * x.shape[1], cfg)

    # the expert FFN: experts on tp, or their hidden dim on tp (summed
    # over tp inside the shard), or whole on every rank
    group = None
    if ep is not None:
        xe_pl = pl(Shard(0), Shard(1))
        w_pl = [pl(None, Shard(0))] * 3
    elif ff is not None:
        xe_pl = rows
        w_pl = [pl(None, Shard(2)), pl(None, Shard(2)), pl(None, Shard(1))]
        group = mesh.get_group(names.index(ax.tp))
    else:
        xe_pl = rows
        w_pl = [pl()] * 3
    w_grad = [[Partial() if n in dp else q for n, q in zip(names, w)] for w in w_pl]

    def ffn_local(xe, wg, wu, wd):
        if group is None:
            return _expert_ffn(xe, wg, wu, wd, cfg)
        ye = _expert_ffn(_SumBackward.apply(xe, group), wg, wu, wd, cfg)
        return _SumForward.apply(ye, group)

    ye = local_map(ffn_local, out_placements=xe_pl, in_placements=(xe_pl, *w_pl),
                   in_grad_placements=(xe_pl, *w_grad), device_mesh=mesh,
                   redistribute_inputs=True)(xe, p.wg, p.wu, p.wd)
    y = local_map(_combine, out_placements=rows, in_placements=(rows, rows, rows),
                  device_mesh=mesh, redistribute_inputs=True)(ye, slot, gk)
    return constrain(y, P(dp, None, None)), aux


def moe_ffn_noaux(x: torch.Tensor, p: Moe, cfg: ArchConfig,
                  ax: MeshAxes = SINGLE) -> torch.Tensor:
    y, _ = moe_ffn(x, p, cfg, ax)
    return y
