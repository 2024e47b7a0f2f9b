"""Train / eval steps (src/repro/train/train_step.py).

``make_train_step`` builds the full update: (state, batch) -> (state,
metrics), with optional microbatch gradient accumulation and AdamW.
Gradients come from ``torch.autograd.grad`` (never accumulated into the
parameters' ``.grad``); with microbatches they are summed in f32 and
divided by the count, as the reference's ``lax.scan`` body does, where
bf16 ``.grad`` accumulation would round each partial sum. The optimizer
sees the reference's stacked trees (``models.convert.stacked_tree``) and
its new values are written back into the layer modules in place: the
state is donated, as the reference's jitted step donates it. The
``params`` module and the optimizer's m and v are updated in place
(``optimizer.adamw_update_``), so the state passed in is the state
returned; the per-layer gradients are freed once stacked.

On a mesh (``train.loop.Trainer(mesh=...)``) the parameters, the
optimizer state and the batch are DTensors laid out by ``state_specs``
and ``data.pipeline.batch_specs``; the same step runs on them, the loss
comes back as the global value on every rank. ``state_shape`` is the
state on ``meta`` tensors (shapes and dtypes, no allocation).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import convert
from repro_torch.models.registry import ModelApi
from repro_torch.models.shardings import MeshAxes, P, is_dtensor
from repro_torch.train import optimizer as opt


@dataclass
class TrainState:
    """``params`` the model (its parameters require grad), ``opt`` the
    stacked optimizer state, ``step`` an int32 0-d tensor."""

    params: Any
    opt: Any
    step: torch.Tensor

    def tree_flatten(self):
        return (self.params, self.opt, self.step), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def init_state(cfg: ArchConfig, api: ModelApi, seed: int, oc: opt.OptConfig, *,
               device=None) -> TrainState:
    dev = resolve_device(device)
    params = api.init(cfg, seed, device=dev)
    params.requires_grad_(True)
    opt_state = opt.init_opt_state(convert.stacked_tree(params), oc)
    return TrainState(params, opt_state, torch.zeros((), dtype=torch.int32, device=dev))


def state_shape(cfg: ArchConfig, api: ModelApi, oc: opt.OptConfig) -> TrainState:
    """The TrainState on ``meta`` tensors: params (the model, uninitialised
    on ``meta``), the stacked optimizer state and the step, with no
    allocation."""
    params = api.init(cfg, None, device="meta")
    return TrainState(params, opt.opt_state_shape(convert.stacked_tree(params), oc),
                      torch.zeros((), dtype=torch.int32, device="meta"))


def state_specs(cfg: ArchConfig, api: ModelApi, ax: MeshAxes, oc: opt.OptConfig) -> TrainState:
    pspecs = api.specs(cfg, ax)
    return TrainState(pspecs, opt.opt_specs(pspecs, oc), P())


def _split_microbatch(batch: dict, m: int, i: int) -> dict:
    def sl(x):
        mb = x.shape[0] // m
        return x[i * mb : (i + 1) * mb]

    return {k: sl(x) for k, x in batch.items()}


def make_loss_fn(cfg: ArchConfig, api: ModelApi, ax: MeshAxes) -> Callable:
    def loss_fn(params, batch):
        return api.loss(params, batch, cfg, ax)

    return loss_fn


def make_train_step(cfg: ArchConfig, api: ModelApi, ax: MeshAxes, oc: opt.OptConfig,
                    microbatches: int | None = None) -> Callable:
    loss_fn = make_loss_fn(cfg, api, ax)
    m = microbatches if microbatches is not None else cfg.microbatches

    def vg(params, batch):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        loss = loss.detach()
        return (loss.full_tensor() if is_dtensor(loss) else loss), grads

    def grads_of(params, batch):
        if m <= 1:
            return vg(params, batch)
        lsum = torch.zeros((), dtype=torch.float32, device=params.device)
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params.parameters()]
        for i in range(m):
            loss, grads = vg(params, _split_microbatch(batch, m, i))
            lsum = lsum + loss
            acc = [a + g.to(torch.float32) for a, g in zip(acc, grads)]
        return lsum / m, [a / m for a in acc]

    def train_step(state: TrainState, batch: dict):
        loss, grads = grads_of(state.params, batch)
        stacked_grads = convert.stacked_tree(state.params, grads)
        del grads
        stacked = convert.stacked_tree(state.params)
        opt_state, om = opt.adamw_update_(stacked_grads, state.opt, stacked, oc)
        del stacked_grads
        convert.load_stacked(state.params, stacked)
        metrics = {"loss": loss, **om, "step": state.step + 1}
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ArchConfig, api: ModelApi, ax: MeshAxes) -> Callable:
    loss_fn = make_loss_fn(cfg, api, ax)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        return loss_fn(state.params, batch)

    return eval_step
