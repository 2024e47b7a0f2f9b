"""Inputs and step builders for every (arch x shape) dry-run cell
(src/repro/launch/specs.py).

``input_specs(cfg, cell, api, ax)`` returns stand-ins for every input of
the cell's step function, with no allocation: the parameters as the
model on ``meta`` tensors, the optimizer state and the step on ``meta``,
every other input a ``TensorSpec``:
  train_*   -> train_step(state, batch)
  prefill_* -> prefill_step(params, batch)
  decode_* / long_* -> decode_step(params, cache, token, pos)

plus matching ``P`` trees (the parameters' as the reference's stacked
spec tree), and the analytic MODEL_FLOPS for the roofline's useful-flops
ratio (6·N_active·D for training; 2·N_active·D prefill; decode adds the
KV-cache attention term 4·L·B·S_ctx·H·hd).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.data.pipeline import batch_specs, shapes_for_cell
from repro_torch.models import convert
from repro_torch.models.registry import ModelApi
from repro_torch.models.shardings import MeshAxes, P, make_serve_plan
from repro_torch.models.stack import tree_leaves
from repro_torch.serve import serve_step as ss
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts


def param_count(cfg: ArchConfig, api: ModelApi, subtree: str | None = None) -> int:
    tree = convert.stacked_tree(api.init(cfg, None, device="meta"))
    if subtree is not None:
        tree = tree.get(subtree, {})
    return sum(leaf.numel() for leaf in tree_leaves(tree))


def expert_params(cfg: ArchConfig) -> int:
    if not cfg.num_experts:
        return 0
    return cfg.num_layers * cfg.num_experts * 3 * cfg.d_model * cfg.d_ff


def active_params(cfg: ArchConfig, n_total: int) -> int:
    ne = expert_params(cfg)
    if not ne:
        return n_total
    frac = cfg.experts_per_token / cfg.num_experts
    return int(n_total - ne * (1 - frac))


def _attn_decode_flops(cfg: ArchConfig, b: int, s_ctx: int) -> float:
    """Per decoded token: q·K + w·V over the live context."""
    if cfg.family == "ssm":
        return 4.0 * cfg.num_layers * b * cfg.d_inner * cfg.ssm_state  # state update
    if not cfg.num_heads:
        return 0.0
    s_eff = min(s_ctx, cfg.sliding_window) if cfg.sliding_window else s_ctx
    layers = cfg.dec_layers or cfg.num_layers
    if cfg.family == "hybrid":
        # only the attn blocks see the window; rec blocks are O(W)
        n_attn = sum(k == "attn" for k in cfg.block_pattern) * (
            cfg.num_layers // len(cfg.block_pattern)
        )
        return 4.0 * n_attn * b * s_eff * cfg.num_heads * cfg.head_dim
    return 4.0 * layers * b * s_eff * cfg.num_heads * cfg.head_dim


def model_flops(cfg: ArchConfig, api: ModelApi, cell: ShapeCell) -> float:
    n = active_params(cfg, param_count(cfg, api))
    b, s = cell.global_batch, cell.seq_len
    if cfg.family == "encdec":
        # the encoder runs once over T_enc frames; only the decoder sees s
        n_enc = param_count(cfg, api, "enc")
        n_embed = param_count(cfg, api, "embed")
        n_dec = n - n_enc - n_embed  # embed is a gather (no matmul flops)
        t_enc = cfg.num_stub_tokens
        if cell.kind == "train":
            return 6.0 * b * (n_enc * t_enc + n_dec * s)
        if cell.kind == "prefill":
            return 2.0 * b * (n_enc * t_enc + n_dec * s)
        return 2.0 * n_dec * b + _attn_decode_flops(cfg, b, s)
    if cell.kind == "train":
        return 6.0 * n * b * s
    if cell.kind == "prefill":
        return 2.0 * n * b * s
    # decode: one token per sequence against an s-long context
    return 2.0 * n * b + _attn_decode_flops(cfg, b, s)


@dataclass
class Cell:
    """Everything needed to trace one (arch x shape x mesh) cell."""

    step: Callable
    args: tuple  # meta tensors, the meta model, TensorSpecs
    in_specs: tuple  # P trees (the parameters' the reference's stacked tree)
    model_flops: float
    kind: str
    meta: dict


def input_specs(cfg: ArchConfig, cell: ShapeCell, api: ModelApi, ax: MeshAxes,
                oc: opt.OptConfig | None = None) -> Cell:
    oc = oc or opt.OptConfig()
    mf = model_flops(cfg, api, cell)
    meta = {"arch": cfg.name, "shape": cell.name, "kind": cell.kind}

    if cell.kind == "train":
        state = ts.state_shape(cfg, api, oc)
        state_specs = ts.state_specs(cfg, api, ax, oc)
        batch = shapes_for_cell(cfg, cell)
        bspecs = batch_specs(cfg, ax)
        step = ts.make_train_step(cfg, api, ax, oc)
        return Cell(step, (state, batch), (state_specs, bspecs), mf, "train", meta)

    if cell.kind == "prefill":
        params = api.init(cfg, None, device="meta")
        pspecs = api.specs(cfg, ax)
        batch = shapes_for_cell(cfg, cell)
        bspecs = {k: v for k, v in batch_specs(cfg, ax).items() if k in batch}
        step = ss.make_prefill_step(cfg, api, ax, cache_len=cell.seq_len)
        return Cell(step, (params, batch), (pspecs, bspecs), mf, "prefill", meta)

    # decode
    b, s = cell.global_batch, cell.seq_len
    params = api.init(cfg, None, device="meta")
    pspecs = api.specs(cfg, ax)
    plan = make_serve_plan(cfg, ax, b, s)
    cache, token, pos = ss.decode_input_shapes(cfg, b, s, api)
    cache_specs = api.cache_specs(cfg, ax, b, plan)
    step = ss.make_decode_step(cfg, api, ax, plan)
    meta["plan"] = {
        "batch_axes": plan.batch_axes, "seq_axes": plan.seq_axes,
        "kv_axes": plan.kv_axes,
    }
    return Cell(
        step,
        (params, cache, token, pos),
        (pspecs, cache_specs, P(plan.batch_axes or None, None), P()),
        mf,
        "decode",
        meta,
    )

