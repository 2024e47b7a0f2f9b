"""Decoder-only transformer LM (src/repro/models/transformer.py): the
``dense`` family (mistral-large, command-r, starcoder2, qwen2), with a
patch-embedding stub prefix the ``vlm`` family (pixtral), and through
the FFN hooks the ``moe`` family's layers (models/registry.py).

Three entry points, as in the reference:
  * ``lm_loss`` — train forward (layers under remat, two-level when
    ``cfg.remat_block``) and ``chunked_xent``, whose logits never exceed
    (B, chunk, V);
  * ``prefill`` — fills a KV cache, returns last-position logits;
  * ``decode_step`` — one token against the ring-buffer cache.

``TransformerLM`` holds the reference's tree as modules: ``embed``
(V, d_model), ``layers.<i>`` (``ln1``, ``attn``, ``ln2``, ``ffn``),
``ln_f`` and, when the embeddings are untied, ``head`` (d_model, V).
``ffn`` is what ``ffn_init`` builds (an ``Mlp`` by default, a
``moe.Moe`` for the moe family). ``prefill`` and ``decode_step`` apply it
with ``ffn_apply`` (``L.mlp`` by default), as the reference's hooks of
the same names; the moe loss runs its own fold (models/registry.py) to
carry the aux, so the train forward takes no hook.
Caches keep the reference's stacked layout ``{"k", "v"}: (L, B, T, KV,
hd)`` in bf16 whatever the compute dtype. The reference's ``res_spec``,
``*_specs`` and ``cache_specs`` are here as trees of ``shardings.P``;
``constrain`` pins the residual at the reference's sites, the identity
unless the residual is a DTensor (a train step on a mesh).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import stack
from repro_torch.models.shardings import (SINGLE, MeshAxes, P, ServePlan, constrain, distribute,
                                          is_dtensor, make_serve_plan, pin_grad)

# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class DecoderLayer(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``ffn`` (``ffn_init``'s module, the MLP
    by default)."""

    def __init__(self, cfg: ArchConfig, gen, dtype, device, ffn_init=None):
        super().__init__()
        self.ln1 = L.init_norm(cfg, cfg.d_model, device)
        self.attn = L.init_attn(gen, cfg, dtype, device)
        self.ln2 = L.init_norm(cfg, cfg.d_model, device)
        self.ffn = (ffn_init or L.init_mlp)(gen, cfg, dtype=dtype, device=device)


def init_decoder_layer(gen, cfg: ArchConfig, dtype=torch.bfloat16, device=None,
                       ffn_init=None) -> DecoderLayer:
    return DecoderLayer(cfg, gen, dtype, device, ffn_init)


class TransformerLM(nn.Module):
    """The dense / vlm LM. ``device=None`` is the card (raises without
    one); ``"cpu"`` only when asked. Weights are drawn from a
    ``torch.Generator`` on the device seeded with ``seed``; ``seed=None``
    leaves them uninitialised for ``models.convert`` to replace."""

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int | None = 0,
                 dtype=torch.bfloat16, ffn_init=None):
        super().__init__()
        dev = resolve_device(device)
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        self.embed = L.init_embed(gen, cfg, dtype, dev)
        self.layers = stack.stacked_init(
            lambda: init_decoder_layer(gen, cfg, dtype=dtype, device=dev, ffn_init=ffn_init),
            cfg.num_layers)
        self.ln_f = L.init_norm(cfg, cfg.d_model, dev)
        if not cfg.tie_embeddings:
            self.head = L.init_dense(gen, cfg.d_model, cfg.vocab_size, False, dtype, dev).w

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_lm(cfg: ArchConfig, seed: int | None = 0, *, device=None,
            dtype=torch.bfloat16) -> TransformerLM:
    return TransformerLM(cfg, device=device, seed=seed, dtype=dtype)


# ---------------------------------------------------------------------------
# sharding specs (trees of P in the reference's stacked layout)
# ---------------------------------------------------------------------------


def norm_specs(cfg: ArchConfig) -> dict:
    s = {"scale": P(None)}
    if cfg.norm == "layernorm":
        s["bias"] = P(None)
    return s


def dense_specs(d_in_spec, d_out_spec, bias: bool) -> dict:
    s = {"w": P(d_in_spec, d_out_spec)}
    if bias:
        s["b"] = P(d_out_spec)
    return s


def attn_specs(cfg: ArchConfig, ax: MeshAxes) -> dict:
    """Column-parallel qkv (out dim on tp), row-parallel out-proj, fsdp on
    the other dim. KV projections replicate over tp when kv_dim % tp != 0."""
    tp_q = ax.tp_if(cfg.q_dim)
    tp_kv = ax.tp_if(cfg.kv_dim)
    fs = ax.fsdp_if(cfg.d_model)
    return {
        "wq": dense_specs(fs, tp_q, cfg.qkv_bias),
        "wk": dense_specs(fs, tp_kv, cfg.qkv_bias),
        "wv": dense_specs(fs, tp_kv, cfg.qkv_bias),
        "wo": dense_specs(tp_q, fs, False),
    }


def mlp_specs(cfg: ArchConfig, ax: MeshAxes, d_ff: int | None = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    tp_f = ax.tp_if(d_ff)
    fs = ax.fsdp_if(cfg.d_model)
    if cfg.act == "gelu":
        return {
            "wi": dense_specs(fs, tp_f, True),
            "wd": dense_specs(tp_f, fs, True),
        }
    return {
        "wg": dense_specs(fs, tp_f, False),
        "wu": dense_specs(fs, tp_f, False),
        "wd": dense_specs(tp_f, fs, False),
    }


def decoder_layer_specs(cfg: ArchConfig, ax: MeshAxes, ffn_specs=None) -> dict:
    return {
        "ln1": norm_specs(cfg),
        "attn": attn_specs(cfg, ax),
        "ln2": norm_specs(cfg),
        "ffn": (ffn_specs or mlp_specs)(cfg, ax),
    }


def embed_specs(cfg: ArchConfig, ax: MeshAxes) -> P:
    return P(ax.tp_if(cfg.vocab_size), ax.fsdp_if(cfg.d_model))


def lm_specs(cfg: ArchConfig, ax: MeshAxes) -> dict:
    specs = {
        "embed": embed_specs(cfg, ax),
        "layers": stack.stacked_specs(decoder_layer_specs(cfg, ax)),
        "ln_f": norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["head"] = P(ax.fsdp_if(cfg.d_model), ax.tp_if(cfg.vocab_size))
    return specs


def res_spec(ax: MeshAxes, s: int) -> P:
    """Residual-stream spec: batch on dp, sequence on tp (Megatron-SP)
    whenever the sequence divides the tp axis."""
    seq = ax.tp if (ax.tp and s % ax.tp_size == 0 and s > 1) else None
    return P(ax.dp, seq, None)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def apply_decoder_layer(x, p: DecoderLayer, cfg: ArchConfig, ax: MeshAxes = SINGLE,
                        positions=None):
    s = x.shape[1]
    x = x + L.attention_train(L.norm(x, p.ln1, cfg), p.attn, cfg, ax, positions)
    x = constrain(x, res_spec(ax, s))
    x = x + L.mlp(L.norm(x, p.ln2, cfg), p.ffn, cfg, ax)
    return constrain(x, res_spec(ax, s))


def _on(t, device) -> torch.Tensor:
    """A batch entry (numpy array or tensor) as a tensor on ``device``."""
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
    return t.to(device)


def _embed_with_prefix(params: TransformerLM, tokens, prefix_embed, ax: MeshAxes = SINGLE):
    """Token embeddings after the stub prefix (cast to their dtype), the
    residual constrained to ``res_spec``."""
    x = L.embed_tokens(params.embed, tokens, ax)
    if prefix_embed is not None:
        x = torch.cat([_on(prefix_embed, x.device).to(x.dtype), x], dim=1)
    return constrain(x, res_spec(ax, x.shape[1]))


def lm_hidden(params: TransformerLM, cfg: ArchConfig, ax: MeshAxes, tokens,
              prefix_embed=None):
    """Token (+ optional stub prefix) embeddings -> final hidden states."""
    x = _embed_with_prefix(params, tokens, prefix_embed, ax)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(h, lp):
        return apply_decoder_layer(h, lp, cfg, ax, positions)

    x = stack.scan_layers(body, x, params.layers, block=cfg.remat_block)
    return L.norm(x, params.ln_f, cfg)


def unembed_weight(params: TransformerLM, cfg: ArchConfig) -> torch.Tensor:
    return params.embed if cfg.tie_embeddings else params.head


def _xent_chunk(xc, w, lc, mc, vocab: int, ax: MeshAxes = SINGLE):
    """One chunk's (sum of masked token losses, mask count), f32."""
    logits = L.unembed(xc, w, vocab, ax).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    # the label's logit from vocab-gathered logits: DTensor's gather on a
    # vocab-sharded operand (a masked partial) fails to reduce
    ll = torch.gather(constrain(logits, P(ax.dp, None, None)), -1, lc[..., None].long())[..., 0]
    return torch.sum((lse - ll) * mc), torch.sum(mc)


def chunked_xent(x, w, labels, cfg: ArchConfig, ax: MeshAxes = SINGLE, loss_mask=None,
                 chunk: int = 256) -> torch.Tensor:
    """Mean cross-entropy without materializing (B, S, V): a loop over S
    chunks, each chunk's (B, chunk, V) logits recomputed in backward
    rather than kept. x (B, S, d); w the (V, d) tied embedding or a
    (d, V) head; labels (B, S) ints on x's device."""
    b, s, _ = x.shape
    chunk = L.fit_chunk(s, chunk)
    x = constrain(x, P(ax.dp, None, None))  # the chunks slice the sequence: gather it
    # the chunks' weight gradient laid out as the weight: a tied embedding
    # adds it to the lookup's, which torch 2.11's DTensor cannot add from
    # another layout
    w = pin_grad(w)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        if loss_mask is None:
            mc = torch.ones((b, chunk), dtype=torch.float32, device=x.device)
        else:
            mc = loss_mask[:, sl].to(torch.float32)
        t, n = checkpoint(_xent_chunk, x[:, sl], w, labels[:, sl], mc, cfg.vocab_size, ax,
                          use_reentrant=False, preserve_rng_state=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params: TransformerLM, batch: dict, cfg: ArchConfig,
            ax: MeshAxes = SINGLE) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (tokens, labels, an
    optional loss_mask, each (B, S), and for vlm the (B, P, d_model)
    ``patch_embed`` prefix, whose positions take no loss)."""
    prefix = batch.get("patch_embed")
    x = lm_hidden(params, cfg, ax, batch["tokens"], prefix_embed=prefix)
    if prefix is not None:
        x = x[:, prefix.shape[1]:]
    mask = batch.get("loss_mask")
    return chunked_xent(x, unembed_weight(params, cfg), _on(batch["labels"], x.device), cfg,
                        ax, None if mask is None else _on(mask, x.device))


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def cache_shape(cfg: ArchConfig, batch: int, cache_len: int, dtype=torch.bfloat16) -> dict:
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": L.TensorSpec(shape, dtype), "v": L.TensorSpec(shape, dtype)}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype=torch.bfloat16, *,
               device=None) -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
            for k, spec in cache_shape(cfg, batch, cache_len, dtype).items()}


def cache_specs(cfg: ArchConfig, ax: MeshAxes, batch: int, plan: ServePlan) -> dict:
    spec = P(plan.batch_axes, plan.seq_axes if plan.seq_axes else None,
             plan.kv_axes if plan.kv_axes else None, None)
    spec = P(None, *spec)  # layer dim
    return {"k": spec, "v": spec}


def prefill_cache(cfg: ArchConfig, ax: MeshAxes, layers: int, b: int, length: int, x) -> dict:
    """A prefill's zero k and v caches, (layers, B, length, KV, hd) bf16;
    beside a DTensor ``x``, DTensors with the batch and KV heads laid out
    as the decode plan lays them out (the sequence whole: the prompt
    writes a prefix of it)."""
    shape = (layers, b, length, cfg.num_kv_heads, cfg.head_dim)
    cache = {k: torch.zeros(shape, dtype=torch.bfloat16, device=x.device) for k in ("k", "v")}
    if is_dtensor(x):
        plan = make_serve_plan(cfg, ax, b, length)
        spec = P(None, plan.batch_axes, None, plan.kv_axes, None)
        cache = {k: distribute(c, spec, x.device_mesh) for k, c in cache.items()}
    return cache


@L.serving
def prefill(params: TransformerLM, tokens, cfg: ArchConfig, ax: MeshAxes = SINGLE,
            cache_len: int = 0, prefix_embed=None, ffn_apply=None):
    """Full-sequence forward that also fills the KV cache. Returns
    (last-position logits (B, V), cache): the cache holds the S
    positions' rotated k and v in bf16, zero-padded to ``cache_len``
    when that is longer (else it keeps length S)."""
    x = _embed_with_prefix(params, tokens, prefix_embed, ax)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    cache = prefill_cache(cfg, ax, cfg.num_layers, b, max(cache_len, s), x)
    for i, lp in enumerate(params.layers):
        xn = L.norm(x, lp.ln1, cfg)
        q, k, v = L.qkv_proj(xn, lp.attn, cfg, ax, positions)
        o = L.attention_core_train(q, L.expand_kv(k, cfg), L.expand_kv(v, cfg), cfg, ax)
        x = constrain(x + L.dense(o, lp.attn.wo.w), res_spec(ax, s))
        x = x + (ffn_apply or L.mlp)(L.norm(x, lp.ln2, cfg), lp.ffn, cfg, ax)
        x = constrain(x, res_spec(ax, s))
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    x = L.norm(x, params.ln_f, cfg)
    logits = L.unembed(x[:, -1:], unembed_weight(params, cfg), cfg.vocab_size, ax)
    return logits[:, 0], cache


@L.serving
def decode_step(params: TransformerLM, token, cache: dict, pos, cfg: ArchConfig,
                ax: MeshAxes = SINGLE, plan: ServePlan | None = None, ffn_apply=None):
    """One-token decode. token: (B, 1) ints; pos: the position being
    written (an int, one for every slot, as in the reference). Returns
    (logits (B, V), the new cache); ``cache`` is left as it was."""
    plan = plan or ServePlan()
    pos = int(pos)
    x = L.embed_tokens(params.embed, token, ax)

    def body(h, lp, lc):
        o, nk, nv = L.attention_decode_general(L.norm(h, lp.ln1, cfg), lc["k"], lc["v"],
                                               lp.attn, cfg, ax, pos, plan)
        h = h + o
        h = h + (ffn_apply or L.mlp)(L.norm(h, lp.ln2, cfg), lp.ffn, cfg, ax)
        return h, {"k": nk, "v": nv}

    x, new_cache = stack.scan_layers_with_cache(body, x, params.layers, cache)
    x = L.norm(x, params.ln_f, cfg)
    logits = L.unembed(x, unembed_weight(params, cfg), cfg.vocab_size, ax)
    return logits[:, 0], new_cache
