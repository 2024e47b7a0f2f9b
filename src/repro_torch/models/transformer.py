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
hd)`` in bf16 whatever the compute dtype. The reference's ``res_spec``
and ``*_specs`` pin shardings on a mesh; on one card there is nothing to
pin, and ``cache_specs`` waits for the mesh slice.
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
from repro_torch.models.shardings import SINGLE, MeshAxes, ServePlan

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
# forward
# ---------------------------------------------------------------------------


def apply_decoder_layer(x, p: DecoderLayer, cfg: ArchConfig, ax: MeshAxes = SINGLE,
                        positions=None):
    x = x + L.attention_train(L.norm(x, p.ln1, cfg), p.attn, cfg, ax, positions)
    return x + L.mlp(L.norm(x, p.ln2, cfg), p.ffn, cfg, ax)


def _on(t, device) -> torch.Tensor:
    """A batch entry (numpy array or tensor) as a tensor on ``device``."""
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
    return t.to(device)


def _embed_with_prefix(params: TransformerLM, tokens, prefix_embed):
    """Token embeddings after the stub prefix (cast to their dtype)."""
    x = L.embed_tokens(params.embed, tokens)
    if prefix_embed is not None:
        x = torch.cat([_on(prefix_embed, x.device).to(x.dtype), x], dim=1)
    return x


def lm_hidden(params: TransformerLM, cfg: ArchConfig, ax: MeshAxes, tokens,
              prefix_embed=None):
    """Token (+ optional stub prefix) embeddings -> final hidden states."""
    x = _embed_with_prefix(params, tokens, prefix_embed)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(h, lp):
        return apply_decoder_layer(h, lp, cfg, ax, positions)

    x = stack.scan_layers(body, x, params.layers, block=cfg.remat_block)
    return L.norm(x, params.ln_f, cfg)


def unembed_weight(params: TransformerLM, cfg: ArchConfig) -> torch.Tensor:
    return params.embed if cfg.tie_embeddings else params.head


def _xent_chunk(xc, w, lc, mc, vocab: int):
    """One chunk's (sum of masked token losses, mask count), f32."""
    logits = L.unembed(xc, w, vocab).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return torch.sum((lse - ll) * mc), torch.sum(mc)


def chunked_xent(x, w, labels, cfg: ArchConfig, ax: MeshAxes = SINGLE, loss_mask=None,
                 chunk: int = 256) -> torch.Tensor:
    """Mean cross-entropy without materializing (B, S, V): a loop over S
    chunks, each chunk's (B, chunk, V) logits recomputed in backward
    rather than kept. x (B, S, d); w the (V, d) tied embedding or a
    (d, V) head; labels (B, S) ints on x's device."""
    b, s, _ = x.shape
    chunk = L.fit_chunk(s, chunk)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        if loss_mask is None:
            mc = torch.ones((b, chunk), dtype=torch.float32, device=x.device)
        else:
            mc = loss_mask[:, sl].to(torch.float32)
        t, n = checkpoint(_xent_chunk, x[:, sl], w, labels[:, sl], mc, cfg.vocab_size,
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


@torch.inference_mode()
def prefill(params: TransformerLM, tokens, cfg: ArchConfig, ax: MeshAxes = SINGLE,
            cache_len: int = 0, prefix_embed=None, ffn_apply=None):
    """Full-sequence forward that also fills the KV cache. Returns
    (last-position logits (B, V), cache): the cache holds the S
    positions' rotated k and v in bf16, zero-padded to ``cache_len``
    when that is longer (else it keeps length S)."""
    x = _embed_with_prefix(params, tokens, prefix_embed)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    shape = (cfg.num_layers, b, max(cache_len, s), cfg.num_kv_heads, cfg.head_dim)
    cache = {k: torch.zeros(shape, dtype=torch.bfloat16, device=x.device) for k in ("k", "v")}
    for i, lp in enumerate(params.layers):
        xn = L.norm(x, lp.ln1, cfg)
        q, k, v = L.qkv_proj(xn, lp.attn, cfg, ax, positions)
        o = L.attention_core_train(q, L.expand_kv(k, cfg), L.expand_kv(v, cfg), cfg, ax)
        x = x + L.dense(o, lp.attn.wo.w)
        x = x + (ffn_apply or L.mlp)(L.norm(x, lp.ln2, cfg), lp.ffn, cfg, ax)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    x = L.norm(x, params.ln_f, cfg)
    logits = L.unembed(x[:, -1:], unembed_weight(params, cfg), cfg.vocab_size)
    return logits[:, 0], cache


@torch.inference_mode()
def decode_step(params: TransformerLM, token, cache: dict, pos, cfg: ArchConfig,
                ax: MeshAxes = SINGLE, plan: ServePlan | None = None, ffn_apply=None):
    """One-token decode. token: (B, 1) ints; pos: the position being
    written (an int, one for every slot, as in the reference). Returns
    (logits (B, V), the new cache); ``cache`` is left as it was."""
    plan = plan or ServePlan()
    pos = int(pos)
    x = L.embed_tokens(params.embed, token)

    def body(h, lp, lc):
        o, nk, nv = L.attention_decode_general(L.norm(h, lp.ln1, cfg), lc["k"], lc["v"],
                                               lp.attn, cfg, ax, pos, plan)
        h = h + o
        h = h + (ffn_apply or L.mlp)(L.norm(h, lp.ln2, cfg), lp.ffn, cfg, ax)
        return h, {"k": nk, "v": nv}

    x, new_cache = stack.scan_layers_with_cache(body, x, params.layers, cache)
    x = L.norm(x, params.ln_f, cfg)
    logits = L.unembed(x, unembed_weight(params, cfg), cfg.vocab_size)
    return logits[:, 0], new_cache
