"""Family registry: one uniform ModelApi per architecture family.

    api = get_model(cfg)
    params            = api.init(cfg, seed, device=...)
    loss              = api.loss(params, batch, cfg, ax)
    logits, cache     = api.prefill(params, batch, cfg, ax, cache_len)
    logits, cache     = api.decode(params, token, cache, pos, cfg, ax, plan)

``batch`` is a dict with ``tokens`` (and ``labels``, an optional
``loss_mask`` for ``loss``; ``patch_embed`` for vlm). The port serves
and trains the ssm family and serves the dense and vlm families; the
moe, hybrid and encdec families wait in ROADMAP queue 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import mamba
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class ModelApi:
    family: str
    init: Callable  # (cfg, seed, *, device, dtype) -> params (unset when seed is None)
    loss: Callable  # (params, batch, cfg, ax) -> scalar
    prefill: Callable  # (params, batch, cfg, ax, cache_len) -> (logits, cache)
    decode: Callable  # (params, token, cache, pos, cfg, ax, plan) -> (logits, cache)
    init_cache: Callable  # (cfg, batch, cache_len, *, device) -> cache
    cache_shape: Callable  # (cfg, batch, cache_len) -> {name: TensorSpec}


# -- dense / vlm --------------------------------------------------------------


def _dense_prefill(params, batch, cfg, ax, cache_len):
    return T.prefill(params, batch["tokens"], cfg, ax, cache_len,
                     prefix_embed=batch.get("patch_embed"))


DENSE = ModelApi(
    family="dense",
    init=T.init_lm,
    loss=T.lm_loss,
    prefill=_dense_prefill,
    decode=T.decode_step,
    init_cache=T.init_cache,
    cache_shape=T.cache_shape,
)

VLM = DENSE  # the patch-embedding stub prefix is handled inside loss/prefill


# -- ssm ----------------------------------------------------------------------


def _ssm_prefill(params, batch, cfg, ax, cache_len):
    return mamba.prefill(params, batch["tokens"], cfg, ax, cache_len)


SSM = ModelApi(
    family="ssm",
    init=mamba.init_lm,
    loss=mamba.lm_loss,
    prefill=_ssm_prefill,
    decode=mamba.decode_step,
    init_cache=mamba.init_cache,
    cache_shape=mamba.cache_shape,
)

_FAMILIES = {"dense": DENSE, "vlm": VLM, "ssm": SSM}


def get_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP queue 1)"
        )
    return _FAMILIES[cfg.family]
