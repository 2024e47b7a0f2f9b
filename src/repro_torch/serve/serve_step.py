"""Serving steps (prefill + single-token decode) and greedy sampling,
used by launch/serve.py and launch/dryrun.py (src/repro/serve/serve_step.py).
PyTorch runs eagerly, so a step is the model call itself; the closures
keep the reference's signatures."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import TensorSpec
from repro_torch.models.registry import ModelApi
from repro_torch.models.shardings import MeshAxes, ServePlan


def make_prefill_step(cfg: ArchConfig, api: ModelApi, ax: MeshAxes, cache_len: int) -> Callable:
    def prefill_step(params, batch):
        return api.prefill(params, batch, cfg, ax, cache_len)

    return prefill_step


def make_decode_step(cfg: ArchConfig, api: ModelApi, ax: MeshAxes, plan: ServePlan) -> Callable:
    def decode_step(params, cache, token, pos):
        return api.decode(params, token, cache, pos, cfg, ax, plan)

    return decode_step


def decode_input_shapes(cfg: ArchConfig, batch: int, cache_len: int, api: ModelApi):
    """Shapes and dtypes of the decode step's (cache, token, pos)."""
    return (
        api.cache_shape(cfg, batch, cache_len),
        TensorSpec((batch, 1), torch.int32),
        TensorSpec((), torch.int32),
    )


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B, 1) int32; ties go to the first maximum, as in
    ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
