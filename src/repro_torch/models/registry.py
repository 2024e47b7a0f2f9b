"""Family registry: one uniform ModelApi per architecture family.

    api = get_model(cfg)
    params            = api.init(cfg, seed, device=...)
    loss              = api.loss(params, batch, cfg, ax)
    logits, cache     = api.prefill(params, batch, cfg, ax, cache_len)
    logits, cache     = api.decode(params, token, cache, pos, cfg, ax, plan)

``batch`` is a dict with ``tokens`` (and ``labels``, an optional
``loss_mask`` for ``loss``; ``patch_embed`` for vlm, ``src_embed`` for
encdec). The port serves and trains all six families, so every one of
the JAX package's ten ids resolves here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import encdec, mamba, moe, rglru, stack
from repro_torch.models import transformer as T
from repro_torch.models.shardings import SINGLE, P, constrain


@dataclass(frozen=True)
class ModelApi:
    family: str
    init: Callable  # (cfg, seed, *, device, dtype) -> params (unset when seed is None)
    specs: Callable  # (cfg, ax) -> tree of P (the reference's stacked layout)
    loss: Callable  # (params, batch, cfg, ax) -> scalar
    prefill: Callable  # (params, batch, cfg, ax, cache_len) -> (logits, cache)
    decode: Callable  # (params, token, cache, pos, cfg, ax, plan) -> (logits, cache)
    init_cache: Callable  # (cfg, batch, cache_len, *, device) -> cache
    cache_shape: Callable  # (cfg, batch, cache_len) -> a tree of TensorSpec
    cache_specs: Callable  # (cfg, ax, batch, plan) -> tree of P


# -- dense / vlm --------------------------------------------------------------


def _dense_prefill(params, batch, cfg, ax, cache_len):
    return T.prefill(params, batch["tokens"], cfg, ax, cache_len,
                     prefix_embed=batch.get("patch_embed"))


DENSE = ModelApi(
    family="dense",
    init=T.init_lm,
    specs=T.lm_specs,
    loss=T.lm_loss,
    prefill=_dense_prefill,
    decode=T.decode_step,
    init_cache=T.init_cache,
    cache_shape=T.cache_shape,
    cache_specs=T.cache_specs,
)

VLM = DENSE  # the patch-embedding stub prefix is handled inside loss/prefill


# -- moe ----------------------------------------------------------------------


def _moe_init(cfg, seed=0, *, device=None, dtype=torch.bfloat16):
    """The dense LM with ``moe.init_moe`` as every layer's FFN."""
    return T.TransformerLM(cfg, device=device, seed=seed, dtype=dtype, ffn_init=moe.init_moe)


def _moe_specs(cfg, ax):
    specs = {
        "embed": T.embed_specs(cfg, ax),
        "layers": stack.stacked_specs(T.decoder_layer_specs(cfg, ax, ffn_specs=moe.moe_specs)),
        "ln_f": T.norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["head"] = P(ax.fsdp_if(cfg.d_model), ax.tp_if(cfg.vocab_size))
    return specs


def _moe_loss(params, batch, cfg, ax=SINGLE):
    """The dense LM's wiring with each layer's load-balance aux carried
    through the fold (weight 0.01, Switch-style), each layer
    rematerialized: the reference's own fold, never the two-level one."""
    x = L.embed_tokens(params.embed, batch["tokens"], ax)
    s = x.shape[1]
    x = constrain(x, T.res_spec(ax, s))
    positions = torch.arange(s, device=x.device)

    def body(h, aux, lp):
        h = h + L.attention_train(L.norm(h, lp.ln1, cfg), lp.attn, cfg, ax, positions)
        h = constrain(h, T.res_spec(ax, s))
        y, a = moe.moe_ffn(L.norm(h, lp.ln2, cfg), lp.ffn, cfg, ax)
        return constrain(h + y, T.res_spec(ax, s)), aux + a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.layers:
        x, aux = stack.remat(body, x, aux, lp)
    x = L.norm(x, params.ln_f, cfg)
    mask = batch.get("loss_mask")
    xent = T.chunked_xent(x, T.unembed_weight(params, cfg), T._on(batch["labels"], x.device),
                          cfg, ax, None if mask is None else T._on(mask, x.device))
    return xent + 0.01 * aux / cfg.num_layers


def _moe_prefill(params, batch, cfg, ax, cache_len):
    return T.prefill(params, batch["tokens"], cfg, ax, cache_len, ffn_apply=moe.moe_ffn_noaux)


def _moe_decode(params, token, cache, pos, cfg, ax, plan):
    return T.decode_step(params, token, cache, pos, cfg, ax, plan, ffn_apply=moe.moe_ffn_noaux)


MOE = ModelApi(
    family="moe",
    init=_moe_init,
    specs=_moe_specs,
    loss=_moe_loss,
    prefill=_moe_prefill,
    decode=_moe_decode,
    init_cache=T.init_cache,
    cache_shape=T.cache_shape,
    cache_specs=T.cache_specs,
)


# -- ssm ----------------------------------------------------------------------


def _ssm_prefill(params, batch, cfg, ax, cache_len):
    return mamba.prefill(params, batch["tokens"], cfg, ax, cache_len)


SSM = ModelApi(
    family="ssm",
    init=mamba.init_lm,
    specs=mamba.lm_specs,
    loss=mamba.lm_loss,
    prefill=_ssm_prefill,
    decode=mamba.decode_step,
    init_cache=mamba.init_cache,
    cache_shape=mamba.cache_shape,
    cache_specs=mamba.cache_specs,
)


# -- hybrid / encdec ----------------------------------------------------------


def _hybrid_prefill(params, batch, cfg, ax, cache_len):
    return rglru.prefill(params, batch["tokens"], cfg, ax, cache_len)


HYBRID = ModelApi(
    family="hybrid",
    init=rglru.init_lm,
    specs=rglru.lm_specs,
    loss=rglru.lm_loss,
    prefill=_hybrid_prefill,
    decode=rglru.decode_step,
    init_cache=rglru.init_cache,
    cache_shape=rglru.cache_shape,
    cache_specs=rglru.cache_specs,
)


def _encdec_prefill(params, batch, cfg, ax, cache_len):
    return encdec.prefill(params, batch["tokens"], cfg, ax, cache_len,
                          src_embed=batch["src_embed"])


ENCDEC = ModelApi(
    family="encdec",
    init=encdec.init_lm,
    specs=encdec.lm_specs,
    loss=encdec.lm_loss,
    prefill=_encdec_prefill,
    decode=encdec.decode_step,
    init_cache=encdec.init_cache,
    cache_shape=encdec.cache_shape,
    cache_specs=encdec.cache_specs,
)

_FAMILIES = {"dense": DENSE, "vlm": VLM, "moe": MOE, "ssm": SSM, "hybrid": HYBRID,
             "encdec": ENCDEC}


def get_model(cfg: ArchConfig) -> ModelApi:
    return _FAMILIES[cfg.family]
