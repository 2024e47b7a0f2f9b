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
else each expert's FFN hidden dim on tp. ``constrain`` pins the
reference's layouts; the moe train step does not yet run on a mesh
(ROADMAP queue 1).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.shardings import SINGLE, MeshAxes, P, constrain


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


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: ArchConfig):
    """x (B, S, D) -> (gates (B, S, kk) f32, expert idx (B, S, kk) int64,
    the Switch-style load-balance aux loss E * sum_e(frac_tokens_e *
    mean_prob_e), f32)."""
    logits = L.einsum_f32("bsd,de->bse", x, router_w.to(x.dtype))
    kk, e = cfg.experts_per_token, cfg.num_experts
    top_vals, top_idx = top_k(logits, kk)
    gates = torch.softmax(top_vals, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    # the mean over (B, S) of each token's one-hot count: integer sums,
    # exact in f32, as the reference's one_hot sum is
    counts = torch.bincount(top_idx.reshape(-1), minlength=e).to(torch.float32)
    frac = counts / (top_idx.shape[0] * top_idx.shape[1]) / kk
    aux = e * torch.sum(frac * torch.mean(probs, dim=(0, 1)))
    return gates, top_idx, aux


def moe_ffn(x: torch.Tensor, p: Moe, cfg: ArchConfig, ax: MeshAxes = SINGLE):
    """Capacity-dropped top-k MoE. x (B, S, D) -> ((B, S, D), aux)."""
    b, s, d = x.shape
    e, kk = cfg.num_experts, cfg.experts_per_token
    cap = capacity(cfg, s)
    gates, idx, aux = route(x, p.router.w, cfg)  # (B, S, kk)

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
    ep, ff = ep_axis(cfg, ax), expert_ff_axis(cfg, ax)
    xe = constrain(xe, P(ax.dp, ep, None, None))

    # the expert FFN, batched over E
    act = L._gelu if cfg.act.startswith("gelu") else F.silu
    h = act(torch.einsum("becd,edf->becf", xe, p.wg)) * torch.einsum(
        "becd,edf->becf", xe, p.wu)
    h = constrain(h, P(ax.dp, ep, None, ff))
    ye = constrain(torch.einsum("becf,efd->becd", h, p.wd), P(ax.dp, ep, None, None))

    # combine: gather back each token's kk expert outputs
    yflat = torch.cat([ye.reshape(b, e * cap, d), ye.new_zeros((b, 1, d))], dim=1)
    yk = yflat[rows[:, None], slot].reshape(b, s, kk, d)
    gk = (gates * keep.reshape(b, s, kk)).to(yk.dtype)
    return constrain(torch.einsum("bskd,bsk->bsd", yk, gk), P(ax.dp, None, None)), aux


def moe_ffn_noaux(x: torch.Tensor, p: Moe, cfg: ArchConfig,
                  ax: MeshAxes = SINGLE) -> torch.Tensor:
    y, _ = moe_ffn(x, p, cfg, ax)
    return y
