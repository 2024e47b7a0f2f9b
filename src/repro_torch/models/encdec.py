"""Encoder-decoder transformer backbone (seamless-m4t family), serving
and training on one card.

The modality frontend is a stub, as in the reference
(src/repro/models/encdec.py): the batch carries precomputed speech-frame
embeddings ``src_embed`` (B, T_frames, d_model). The encoder (bidirectional
layers), the decoder (causal self-attention, cross-attention over the
encoder's states, the classic gelu MLP) and the untied vocab head are
real. Positions are sinusoidal and added to the embeddings (no RoPE).

``EncDecLM`` holds the reference's tree as modules: ``embed`` (V,
d_model), ``enc.<i>`` (``ln1``, ``attn``, ``ln2``, ``ffn``), ``dec.<i>``
(``ln1``, ``self_attn``, ``ln2``, ``cross_attn``, ``ln3``, ``ffn``),
``ln_enc``, ``ln_dec`` and ``head`` (d_model, V). The cache is
``{"k", "v"}: (L_dec, B, T, KV, hd)`` and ``{"mem_k", "mem_v"}: (L_dec,
B, T_frames, KV, hd)``, all bf16.

``encode`` casts the frames and their positions to bf16, as the
reference does. With float32 weights the first encoder layer's residual
then promotes to float32 and stays there; the reference's ``lax.scan``
refuses that carry (a ``TypeError``), so the port runs in float32 where
the reference runs only in bf16. No hand-written kernel is on this path.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import stack
from repro_torch.models import transformer as T
from repro_torch.models.shardings import SINGLE, MeshAxes, P, ServePlan, constrain


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(S,) positions -> (S, d) f32: sines then cosines."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[:, None].to(torch.float32) * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class DecLayer(nn.Module):
    """``ln1``, ``self_attn``, ``ln2``, ``cross_attn``, ``ln3``, ``ffn``."""

    def __init__(self, cfg: ArchConfig, gen, dtype, device):
        super().__init__()
        self.ln1 = L.init_norm(cfg, cfg.d_model, device)
        self.self_attn = L.init_attn(gen, cfg, dtype, device)
        self.ln2 = L.init_norm(cfg, cfg.d_model, device)
        self.cross_attn = L.init_attn(gen, cfg, dtype, device)
        self.ln3 = L.init_norm(cfg, cfg.d_model, device)
        self.ffn = L.init_mlp(gen, cfg, dtype=dtype, device=device)


def init_enc_layer(gen, cfg: ArchConfig, dtype=torch.bfloat16, device=None) -> T.DecoderLayer:
    return T.init_decoder_layer(gen, cfg, dtype, device)  # same shape: attn + mlp


def init_dec_layer(gen, cfg: ArchConfig, dtype=torch.bfloat16, device=None) -> DecLayer:
    return DecLayer(cfg, gen, dtype, device)


class EncDecLM(nn.Module):
    """The encdec LM. ``device=None`` is the card (raises without one);
    ``"cpu"`` only when asked. Weights are drawn from a
    ``torch.Generator`` on the device seeded with ``seed``;
    ``seed=None`` leaves them uninitialised for ``models.convert``."""

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int | None = 0,
                 dtype=torch.bfloat16):
        super().__init__()
        dev = resolve_device(device)
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        self.embed = L.init_embed(gen, cfg, dtype, dev)
        self.enc = stack.stacked_init(lambda: init_enc_layer(gen, cfg, dtype, dev),
                                      cfg.enc_layers)
        self.dec = stack.stacked_init(lambda: init_dec_layer(gen, cfg, dtype, dev),
                                      cfg.dec_layers)
        self.ln_enc = L.init_norm(cfg, cfg.d_model, dev)
        self.ln_dec = L.init_norm(cfg, cfg.d_model, dev)
        self.head = L.init_dense(gen, cfg.d_model, cfg.vocab_size, False, dtype, dev).w

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_lm(cfg: ArchConfig, seed: int | None = 0, *, device=None,
            dtype=torch.bfloat16) -> EncDecLM:
    return EncDecLM(cfg, device=device, seed=seed, dtype=dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def dec_layer_specs(cfg: ArchConfig, ax: MeshAxes) -> dict:
    return {
        "ln1": T.norm_specs(cfg),
        "self_attn": T.attn_specs(cfg, ax),
        "ln2": T.norm_specs(cfg),
        "cross_attn": T.attn_specs(cfg, ax),
        "ln3": T.norm_specs(cfg),
        "ffn": T.mlp_specs(cfg, ax),
    }


def lm_specs(cfg: ArchConfig, ax: MeshAxes) -> dict:
    return {
        "embed": P(ax.tp_if(cfg.vocab_size), ax.fsdp_if(cfg.d_model)),
        "enc": stack.stacked_specs(T.decoder_layer_specs(cfg, ax)),
        "dec": stack.stacked_specs(dec_layer_specs(cfg, ax)),
        "ln_enc": T.norm_specs(cfg),
        "ln_dec": T.norm_specs(cfg),
        "head": P(ax.fsdp_if(cfg.d_model), ax.tp_if(cfg.vocab_size)),
    }


def encode(params: EncDecLM, src_embed, cfg: ArchConfig, ax: MeshAxes = SINGLE):
    """src_embed: (B, T, D) precomputed frames -> encoder states (B, T, D)."""
    src = T._on(src_embed, params.device)
    t, d = src.shape[1], src.shape[2]
    pos = sinusoid(torch.arange(t, device=src.device), d)
    x = src.to(torch.bfloat16) + pos[None].to(torch.bfloat16)
    x = constrain(x, T.res_spec(ax, t))

    def body(h, lp):
        h = h + L.attention_train(L.norm(h, lp.ln1, cfg), lp.attn, cfg, ax, None,
                                  bidirectional=True)
        h = constrain(h, T.res_spec(ax, t))
        h = h + L.mlp(L.norm(h, lp.ln2, cfg), lp.ffn, cfg, ax)
        return constrain(h, T.res_spec(ax, t))

    x = stack.scan_layers(body, x, params.enc)
    return L.norm(x, params.ln_enc, cfg)


def _cross_kv(mem, lp: DecLayer, cfg: ArchConfig):
    b, t, _ = mem.shape
    k = L._dense_of(mem, lp.cross_attn.wk)
    v = L._dense_of(mem, lp.cross_attn.wv)
    return (k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim))


def apply_dec_layer(x, lp: DecLayer, mem, cfg: ArchConfig, ax: MeshAxes = SINGLE):
    s = x.shape[1]
    x = x + L.attention_train(L.norm(x, lp.ln1, cfg), lp.self_attn, cfg, ax, None)
    x = constrain(x, T.res_spec(ax, s))
    mk, mv = _cross_kv(mem, lp, cfg)
    x = x + L.cross_attention(L.norm(x, lp.ln2, cfg), mk, mv, lp.cross_attn, cfg, ax)
    x = constrain(x, T.res_spec(ax, s))
    x = x + L.mlp(L.norm(x, lp.ln3, cfg), lp.ffn, cfg, ax)
    return constrain(x, T.res_spec(ax, s))


def _embed_dec(params: EncDecLM, tokens, cfg: ArchConfig, positions: torch.Tensor,
               ax: MeshAxes = SINGLE):
    x = L.embed_tokens(params.embed, tokens, ax)
    x = x + sinusoid(positions.to(x.device), cfg.d_model)[None].to(x.dtype)
    return constrain(x, T.res_spec(ax, x.shape[1]))


def lm_loss(params: EncDecLM, batch: dict, cfg: ArchConfig, ax: MeshAxes = SINGLE):
    """Mean next-token cross-entropy of the decoder's ``batch`` (tokens,
    labels, an optional loss_mask) given the encoder's ``src_embed``;
    both stacks under per-layer remat, then ``chunked_xent`` against the
    head."""
    mem = encode(params, batch["src_embed"], cfg, ax)
    s = batch["tokens"].shape[1]
    x = _embed_dec(params, batch["tokens"], cfg, torch.arange(s), ax)

    def body(h, lp):
        return apply_dec_layer(h, lp, mem, cfg, ax)

    x = stack.scan_layers(body, x, params.dec)
    x = L.norm(x, params.ln_dec, cfg)
    mask = batch.get("loss_mask")
    return T.chunked_xent(x, params.head, T._on(batch["labels"], x.device), cfg, ax,
                          None if mask is None else T._on(mask, x.device))


# ---------------------------------------------------------------------------
# serving (decoder-side KV cache + precomputed cross-attn memory)
# ---------------------------------------------------------------------------


def cache_shape(cfg: ArchConfig, batch: int, cache_len: int,
                mem_len: int | None = None) -> dict:
    mem_len = mem_len or cfg.num_stub_tokens
    kv = (cfg.dec_layers, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    xk = (cfg.dec_layers, batch, mem_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": L.TensorSpec(kv, torch.bfloat16), "v": L.TensorSpec(kv, torch.bfloat16),
            "mem_k": L.TensorSpec(xk, torch.bfloat16), "mem_v": L.TensorSpec(xk, torch.bfloat16)}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, mem_len: int | None = None, *,
               device=None) -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
            for k, spec in cache_shape(cfg, batch, cache_len, mem_len).items()}


def cache_specs(cfg: ArchConfig, ax: MeshAxes, batch: int, plan: ServePlan) -> dict:
    b = plan.batch_axes or None
    kv_spec = P(None, b, plan.seq_axes if plan.seq_axes else None,
                plan.kv_axes if plan.kv_axes else None, None)
    mem_spec = P(None, b, None, plan.kv_axes if plan.kv_axes else None, None)
    return {"k": kv_spec, "v": kv_spec, "mem_k": mem_spec, "mem_v": mem_spec}


@L.serving
def prefill(params: EncDecLM, tokens, cfg: ArchConfig, ax: MeshAxes = SINGLE,
            cache_len: int = 0, src_embed=None):
    """Encoder pass + decoder prompt pass; returns (last logits, cache):
    the prompt's self-attention k and v zero-padded to ``cache_len``
    when that is longer, and each layer's cross-attention memory."""
    mem = encode(params, src_embed, cfg, ax)
    s = tokens.shape[1]
    x = _embed_dec(params, tokens, cfg, torch.arange(s), ax)
    b = x.shape[0]
    cache = T.prefill_cache(cfg, ax, cfg.dec_layers, b, max(cache_len, s), x)
    mks, mvs = [], []
    for i, lp in enumerate(params.dec):
        q, k, v = L.qkv_proj(L.norm(x, lp.ln1, cfg), lp.self_attn, cfg, ax, None)
        o = L.attention_core_train(q, L.expand_kv(k, cfg), L.expand_kv(v, cfg), cfg, ax)
        x = constrain(x + L._dense_of(o, lp.self_attn.wo), T.res_spec(ax, s))
        mk, mv = _cross_kv(mem, lp, cfg)
        x = x + L.cross_attention(L.norm(x, lp.ln2, cfg), mk, mv, lp.cross_attn, cfg, ax)
        x = constrain(x, T.res_spec(ax, s))
        x = x + L.mlp(L.norm(x, lp.ln3, cfg), lp.ffn, cfg, ax)
        x = constrain(x, T.res_spec(ax, s))
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        mks.append(mk.to(torch.bfloat16))
        mvs.append(mv.to(torch.bfloat16))
    x = L.norm(x, params.ln_dec, cfg)
    logits = L.unembed(x[:, -1:], params.head, cfg.vocab_size, ax)
    cache["mem_k"], cache["mem_v"] = torch.stack(mks), torch.stack(mvs)
    return logits[:, 0], cache


@L.serving
def decode_step(params: EncDecLM, token, cache: dict, pos, cfg: ArchConfig,
                ax: MeshAxes = SINGLE, plan: ServePlan | None = None):
    """One-token decode: self-attention over the ring cache, then
    cross-attention over the cached memory. Returns (logits (B, V), the
    new cache); ``cache`` is left as it was."""
    plan = plan or ServePlan()
    pos = int(pos)
    x = _embed_dec(params, token, cfg, torch.full((1,), pos), ax)

    def body(h, lp, lc):
        o, nk, nv = L.attention_decode_general(L.norm(h, lp.ln1, cfg), lc["k"], lc["v"],
                                               lp.self_attn, cfg, ax, pos, plan)
        h = h + o
        h = h + L.cross_attention(L.norm(h, lp.ln2, cfg), lc["mem_k"], lc["mem_v"],
                                  lp.cross_attn, cfg, ax)
        h = h + L.mlp(L.norm(h, lp.ln3, cfg), lp.ffn, cfg, ax)
        return h, {"k": nk, "v": nv, "mem_k": lc["mem_k"], "mem_v": lc["mem_v"]}

    x, new_cache = stack.scan_layers_with_cache(body, x, params.dec, cache)
    x = L.norm(x, params.ln_dec, cfg)
    logits = L.unembed(x, params.head, cfg.vocab_size, ax)
    return logits[:, 0], new_cache
