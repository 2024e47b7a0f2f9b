"""Griffin-style hybrid blocks (recurrentgemma family): RG-LRU recurrent
blocks interleaved 2:1 with local sliding-window MQA blocks
[arXiv:2402.19427], serving and training on one card.

Layer pattern: the 38-layer stack is 12 copies of the (rec, rec, attn)
group, the ``groups`` ``ModuleList`` (stacked on a leading G in the
reference's tree), and a (rec, rec) ``tail``, a list of blocks that the
reference keeps unstacked (tree path ``tail/<i>/...``). A tail leaf
keeps its own rank: a tail norm scale is 1-D, so AdamW gives it no
weight decay, while the same scale inside ``groups`` is 2-D and does.

RG-LRU recurrence (diagonal, per channel):
    r_t = sigmoid(W_r x_t)         (block-diagonal gate, H blocks)
    i_t = sigmoid(W_i x_t)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

``rglru_scan`` runs the whole prompt through K8 (``kernels.selective_scan``)
with N = 1 and c = 1: its recurrence h_t = da_t h_{t-1} + dbu_t is this
one with da = a and dbu = sqrt(1 - a^2) i x, and its output
y_t = h_t * 1 is h_t exactly. One launch per layer covers the whole
prompt (K8 carries h in registers over S), where the reference walks
``fit_chunk(S, scan_chunk)`` chunks with an associative scan. On a CUDA
tensor that is the CUDA kernel's ring body (one warp streams 32 columns
through all of S); on a CPU tensor its plain version. Under grad
(``lm_loss``) the reference's own chunked associative scan runs instead
(``mamba._associative_scan``), exactly as ``mamba_mix`` decides: K8 has
no backward and refuses an operand that requires grad. The one-token
``rglru_step`` of decode is torch ops, as in the reference.

The sliding-window KV cache is O(window) and the LRU state O(1), which
is what makes long contexts native for this family. Layouts are the
reference's (src/repro/models/rglru.py): dense weights ``(d_in, d_out)``
applied as ``x @ w``; the cache ``{"groups": {b<i>: ...} stacked on G,
"tail": [...]}`` with a rec block's ``{conv (B, d_conv - 1, W) bf16,
lru (B, W) f32}`` and an attention block's ``{k, v (B, window, KV, hd)
bf16}``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models import layers as L
from repro_torch.models import stack
from repro_torch.models.layers import TensorSpec
from repro_torch.models.mamba import _associative_scan, _causal_conv
from repro_torch.models import transformer as T
from repro_torch.models.shardings import (SINGLE, MeshAxes, P, ServePlan, constrain, distribute,
                                          is_dtensor, placements)
from repro_torch.models.transformer import _on, chunked_xent, res_spec

_C = 8.0  # RG-LRU temperature

# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class RgLru(nn.Module):
    """``w_r``, ``w_i`` (H, W/H, W/H) block-diagonal gates; ``b_r``,
    ``b_i`` and ``lam`` (W,) f32."""

    def __init__(self, cfg: ArchConfig, gen, dtype, device):
        super().__init__()
        w, h = cfg.lru_width, cfg.num_heads
        wh = w // h
        f32 = dict(dtype=torch.float32, device=device)
        if gen is None:
            lam = torch.empty((w,), **f32)
        else:  # a ~ U(0.9, 0.999)^(c softplus(lam)) (Griffin appendix)
            u = torch.rand((w,), generator=gen, **f32) * (0.999 - 0.9) + 0.9
            lam = torch.log(torch.expm1(-torch.log(u) / _C))  # softplus^-1(-log(u)/c)
        self.w_r = L.param(L.draw(gen, (h, wh, wh), 1.0 / math.sqrt(wh), dtype, device))
        self.w_i = L.param(L.draw(gen, (h, wh, wh), 1.0 / math.sqrt(wh), dtype, device))
        self.b_r = L.param(torch.zeros((w,), **f32))
        self.b_i = L.param(torch.zeros((w,), **f32))
        self.lam = L.param(lam)


class RecBlock(nn.Module):
    """The recurrent temporal mix: ``lin_x``, ``lin_y`` (d_model, W),
    the causal conv ``conv_w`` (d_conv, W) and ``conv_b``, ``lru``,
    ``lin_out`` (W, d_model)."""

    def __init__(self, cfg: ArchConfig, gen, dtype, device):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width
        self.lin_x = L.init_dense(gen, d, w, False, dtype, device)
        self.lin_y = L.init_dense(gen, d, w, False, dtype, device)
        self.conv_w = L.param(L.draw(gen, (cfg.d_conv, w), 0.5, dtype, device))
        self.conv_b = L.param(torch.zeros((w,), dtype=torch.float32, device=device))
        self.lru = RgLru(cfg, gen, dtype, device)
        self.lin_out = L.init_dense(gen, w, d, False, dtype, device)


class Block(nn.Module):
    """``ln1``, ``mix`` (a ``RecBlock`` for "rec", an ``Attn`` for
    "attn"), ``ln2``, ``ffn``."""

    def __init__(self, cfg: ArchConfig, kind: str, gen, dtype, device):
        super().__init__()
        self.ln1 = L.init_norm(cfg, cfg.d_model, device)
        self.mix = (RecBlock(cfg, gen, dtype, device) if kind == "rec"
                    else L.init_attn(gen, cfg, dtype, device))
        self.ln2 = L.init_norm(cfg, cfg.d_model, device)
        self.ffn = L.init_mlp(gen, cfg, dtype=dtype, device=device)


class Group(nn.Module):
    """One copy of ``block_pattern``: ``b0``, ``b1``, ... of its kinds."""

    def __init__(self, cfg: ArchConfig, gen, dtype, device):
        super().__init__()
        for i, kind in enumerate(cfg.block_pattern):
            setattr(self, f"b{i}", Block(cfg, kind, gen, dtype, device))


def _group_layout(cfg: ArchConfig) -> tuple[int, tuple[str, ...]]:
    pat = cfg.block_pattern
    return cfg.num_layers // len(pat), pat[: cfg.num_layers % len(pat)]


class HybridLM(nn.Module):
    """The hybrid-family LM: ``embed`` (vocab, d_model), tied as the
    output head; ``groups``; ``tail``; ``ln_f``.

    ``device=None`` is the card (raises without one); ``"cpu"`` only
    when asked. Weights are drawn from a ``torch.Generator`` on the
    device seeded with ``seed``; ``seed=None`` leaves them uninitialised
    for ``models.convert`` to replace."""

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int | None = 0,
                 dtype=torch.bfloat16):
        super().__init__()
        dev = resolve_device(device)
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        groups, tail = _group_layout(cfg)
        self.embed = L.init_embed(gen, cfg, dtype, dev)
        self.groups = stack.stacked_init(lambda: Group(cfg, gen, dtype, dev), groups)
        self.tail = nn.ModuleList(Block(cfg, kind, gen, dtype, dev) for kind in tail)
        self.ln_f = L.init_norm(cfg, cfg.d_model, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_lm(cfg: ArchConfig, seed: int | None = 0, *, device=None,
            dtype=torch.bfloat16) -> HybridLM:
    return HybridLM(cfg, device=device, seed=seed, dtype=dtype)


# ---------------------------------------------------------------------------
# sharding specs (trees of P in the reference's layout)
# ---------------------------------------------------------------------------


def rglru_specs(cfg: ArchConfig, ax: MeshAxes) -> dict:
    tp_h = ax.tp_if(cfg.num_heads)
    return {
        "w_r": P(tp_h, None, None),
        "w_i": P(tp_h, None, None),
        "b_r": P(None),
        "b_i": P(None),
        "lam": P(None),
    }


def rec_block_specs(cfg: ArchConfig, ax: MeshAxes) -> dict:
    tp = ax.tp_if(cfg.lru_width)
    fs = ax.fsdp_if(cfg.d_model)
    return {
        "lin_x": {"w": P(fs, tp)},
        "lin_y": {"w": P(fs, tp)},
        "conv_w": P(None, tp),
        "conv_b": P(tp),
        "lru": rglru_specs(cfg, ax),
        "lin_out": {"w": P(tp, fs)},
    }


def block_specs(cfg: ArchConfig, ax: MeshAxes, kind: str) -> dict:
    mix = rec_block_specs(cfg, ax) if kind == "rec" else T.attn_specs(cfg, ax)
    return {
        "ln1": T.norm_specs(cfg),
        "mix": mix,
        "ln2": T.norm_specs(cfg),
        "ffn": T.mlp_specs(cfg, ax),
    }


def group_specs(cfg: ArchConfig, ax: MeshAxes) -> dict:
    return {f"b{i}": block_specs(cfg, ax, kind) for i, kind in enumerate(cfg.block_pattern)}


def lm_specs(cfg: ArchConfig, ax: MeshAxes) -> dict:
    _, tail = _group_layout(cfg)
    return {
        "embed": P(ax.tp_if(cfg.vocab_size), ax.fsdp_if(cfg.d_model)),
        "groups": stack.stacked_specs(group_specs(cfg, ax)),
        "tail": [block_specs(cfg, ax, kind) for kind in tail],
        "ln_f": T.norm_specs(cfg),
    }


def _block_cache_specs(cfg: ArchConfig, ax: MeshAxes, kind: str, plan: ServePlan) -> dict:
    b = plan.batch_axes or None
    if kind == "rec":
        tp = ax.tp_if(cfg.lru_width)
        return {"conv": P(b, None, tp), "lru": P(b, tp)}
    # window cache is small; shard batch only (window rarely divides tp)
    return {"k": P(b, None, None, None), "v": P(b, None, None, None)}


def cache_specs(cfg: ArchConfig, ax: MeshAxes, batch: int, plan: ServePlan) -> dict:
    _, tail = _group_layout(cfg)
    g = {f"b{i}": _block_cache_specs(cfg, ax, kind, plan)
         for i, kind in enumerate(cfg.block_pattern)}
    return {
        "groups": stack.stacked_specs(g),
        "tail": [_block_cache_specs(cfg, ax, kind, plan) for kind in tail],
    }


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------


def _gates(x, p: RgLru, cfg: ArchConfig):
    """x: (B, S, W) -> (log_a (B, S, W) f32, gated input (B, S, W) f32)."""
    b, s, w = x.shape
    h = cfg.num_heads
    xh = x.reshape(b, s, h, w // h)
    r = L.einsum_f32("bshi,hij->bshj", xh, p.w_r)
    i = L.einsum_f32("bshi,hij->bshj", xh, p.w_i)
    r = torch.sigmoid(r.reshape(b, s, w) + p.b_r)
    i = torch.sigmoid(i.reshape(b, s, w) + p.b_i)
    log_a = -_C * F.softplus(p.lam) * r
    return log_a, i * x.float()


def _scan_shards(da, dbu, cm, h0, ax: MeshAxes):
    """K8 with its last state, (y, h_last). On DTensors each rank scans
    its own shard (``local_map``): the batch rows on the dp axes and D on
    tp, as the reference's ``act`` spec lays them out; a plain ``cm`` or
    ``h0`` (a fresh state) is laid out the same way first."""
    if not is_dtensor(da):
        return selective_scan(da, dbu, cm, h0=h0, return_state=True)
    from torch.distributed.tensor.experimental import local_map

    mesh, tp, dp = da.device_mesh, ax.tp_if(da.shape[2]), ax.dp_if(da.shape[0])
    pl = lambda spec: list(placements(spec, mesh))
    specs = (P(dp, None, tp, None), P(dp, None, tp, None), P(dp, None, None), P(dp, tp, None))
    args = [t if is_dtensor(t) else distribute(t, sp, mesh)
            for t, sp in zip((da, dbu, cm, h0), specs)]

    def local(a, b, c, h):
        return selective_scan(a.contiguous(), b.contiguous(), c.contiguous(),
                              h0=h.contiguous(), return_state=True)

    return local_map(local, out_placements=(pl(P(dp, None, tp)), pl(specs[3])),
                     in_placements=tuple(pl(sp) for sp in specs), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def rglru_scan(x, p: RgLru, cfg: ArchConfig, h0=None, ax: MeshAxes = SINGLE):
    """x: (B, S, W); h0: (B, W) f32 carry. Returns (y (B, S, W) in x's
    dtype, h_last (B, W) f32): through K8 unless grad is needed (see
    the module docstring)."""
    b, s, w = x.shape
    log_a, gated = _gates(x, p, cfg)
    a = torch.exp(log_a)
    bt = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gated
    if h0 is None:
        h0 = torch.zeros((b, w), dtype=torch.float32, device=x.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, bt, h0)):
        chunk = L.fit_chunk(s, cfg.scan_chunk)
        h, ys = h0, []
        for c0 in range(0, s, chunk):
            a_cum, b_cum = _associative_scan(a[:, c0 : c0 + chunk], bt[:, c0 : c0 + chunk])
            hs = b_cum + a_cum * h[:, None]
            h = hs[:, -1]
            ys.append(hs.to(x.dtype))
        return torch.cat(ys, dim=1), h
    ones = torch.ones((b, s, 1), dtype=torch.float32, device=x.device)
    y, h = _scan_shards(a.reshape(b, s, w, 1), bt.reshape(b, s, w, 1), ones,
                        h0.reshape(b, w, 1).contiguous(), ax)
    return y.to(x.dtype), h.reshape(b, w)


def rglru_step(x1, p: RgLru, cfg: ArchConfig, h):
    """One-token recurrence. x1: (B, 1, W); h: (B, W) f32."""
    log_a, gated = _gates(x1, p, cfg)
    a = torch.exp(log_a[:, 0])
    bt = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated[:, 0]
    h = a * h + bt
    return h.to(x1.dtype)[:, None], h


def rec_mix(x, p: RecBlock, cfg: ArchConfig, ax: MeshAxes = SINGLE, state=None):
    """Griffin recurrent temporal mix. state: None or dict(conv, lru).
    Returns (out (B, S, d_model), the new state)."""
    xb = L.dense(x, p.lin_x.w)
    yb = L._gelu(L.dense(x, p.lin_y.w))
    xb = constrain(xb, P(ax.dp_if(x.shape[0]), None, ax.tp_if(cfg.lru_width)))
    conv0 = state["conv"] if state else None
    xb, conv_state = _causal_conv(xb, p.conv_w, p.conv_b, conv0)
    if x.shape[1] == 1 and state is not None:
        lru_out, h_last = rglru_step(xb, p.lru, cfg, state["lru"])
    else:
        lru_out, h_last = rglru_scan(xb, p.lru, cfg, state["lru"] if state else None, ax)
    out = L.dense(lru_out * yb, p.lin_out.w)
    return out, {"conv": conv_state, "lru": h_last}


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------


def _embed(params: HybridLM, tokens, cfg: ArchConfig, ax: MeshAxes = SINGLE):
    """Token embeddings times the gemma scale sqrt(d_model), the scale
    rounded to the embedding's dtype first, as JAX rounds a weak python
    scalar (the product of two bf16 values is exact in the f32 that
    torch computes it in, then rounded once, as in JAX)."""
    x = L.embed_tokens(params.embed, tokens, ax)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()


def apply_block(x, p: Block, kind: str, cfg: ArchConfig, ax: MeshAxes, positions):
    s = x.shape[1]
    xn = L.norm(x, p.ln1, cfg)
    if kind == "rec":
        mix, _ = rec_mix(xn, p.mix, cfg, ax)
    else:
        mix = L.attention_train(xn, p.mix, cfg, ax, positions)
    x = constrain(x + mix, res_spec(ax, s))
    x = x + L.mlp(L.norm(x, p.ln2, cfg), p.ffn, cfg, ax)
    return constrain(x, res_spec(ax, s))


def lm_loss(params: HybridLM, batch: dict, cfg: ArchConfig, ax: MeshAxes = SINGLE):
    """Mean next-token cross-entropy of ``batch`` (tokens, labels, an
    optional loss_mask): the scaled embedding, the groups with per-group
    remat, the tail without remat (as the reference), ``ln_f`` and
    ``chunked_xent`` against the tied embedding."""
    x = _embed(params, batch["tokens"], cfg, ax)
    x = constrain(x, res_spec(ax, x.shape[1]))
    positions = torch.arange(x.shape[1], device=x.device)
    pat = cfg.block_pattern

    def group_body(h, gp):
        for i, kind in enumerate(pat):
            h = apply_block(h, getattr(gp, f"b{i}"), kind, cfg, ax, positions)
        return h

    x = stack.scan_layers(group_body, x, params.groups)
    _, tail = _group_layout(cfg)
    for p, kind in zip(params.tail, tail):
        x = apply_block(x, p, kind, cfg, ax, positions)
    x = L.norm(x, params.ln_f, cfg)
    mask = batch.get("loss_mask")
    return chunked_xent(x, params.embed, _on(batch["labels"], x.device), cfg, ax,
                        None if mask is None else _on(mask, x.device))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _block_cache(cfg: ArchConfig, kind: str, batch: int, window: int) -> dict:
    if kind == "rec":
        return {"conv": TensorSpec((batch, cfg.d_conv - 1, cfg.lru_width), torch.bfloat16),
                "lru": TensorSpec((batch, cfg.lru_width), torch.float32)}
    kv = TensorSpec((batch, window, cfg.num_kv_heads, cfg.head_dim), torch.bfloat16)
    return {"k": kv, "v": kv}


def _cache_window(cfg: ArchConfig, cache_len: int) -> int:
    # local attention only ever needs the window, regardless of context len
    return min(cfg.sliding_window or cache_len, cache_len)


def cache_shape(cfg: ArchConfig, batch: int, cache_len: int) -> dict:
    """``{"groups": {b<i>: {name: TensorSpec}} (leading G), "tail": [...]}``."""
    groups, tail = _group_layout(cfg)
    w = _cache_window(cfg, cache_len)
    gcache = {f"b{i}": {k: TensorSpec((groups, *s.shape), s.dtype)
                        for k, s in _block_cache(cfg, kind, batch, w).items()}
              for i, kind in enumerate(cfg.block_pattern)}
    return {"groups": gcache, "tail": [_block_cache(cfg, kind, batch, w) for kind in tail]}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *, device=None) -> dict:
    dev = resolve_device(device)
    return stack.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                          cache_shape(cfg, batch, cache_len))


def _decode_block(x1, p: Block, kind: str, cfg: ArchConfig, ax: MeshAxes, pos: int, lc,
                  plan: ServePlan):
    xn = L.norm(x1, p.ln1, cfg)
    if kind == "rec":
        mix, st = rec_mix(xn, p.mix, cfg, ax, state=lc)
    else:
        wplan = ServePlan(batch_axes=plan.batch_axes)  # window cache: no seq shard
        mix, nk, nv = L.attention_decode_general(xn, lc["k"], lc["v"], p.mix, cfg, ax, pos,
                                                 wplan)
        st = {"k": nk, "v": nv}
    x1 = x1 + mix
    return x1 + L.mlp(L.norm(x1, p.ln2, cfg), p.ffn, cfg, ax), st


@L.serving
def decode_step(params: HybridLM, token, cache: dict, pos, cfg: ArchConfig,
                ax: MeshAxes = SINGLE, plan: ServePlan | None = None):
    """One-token decode: each rec block one recurrence step from its
    carried conv and LRU state, each attention block one token over its
    window ring. Returns (logits (B, V), the new cache); ``cache`` is
    left as it was."""
    plan = plan or ServePlan()
    pos = int(pos)
    x = _embed(params, token, cfg, ax)
    pat = cfg.block_pattern

    def group_body(h, gp, gc):
        ncache = {}
        for i, kind in enumerate(pat):
            h, ncache[f"b{i}"] = _decode_block(h, getattr(gp, f"b{i}"), kind, cfg, ax, pos,
                                               gc[f"b{i}"], plan)
        return h, ncache

    x, gcache = stack.scan_layers_with_cache(group_body, x, params.groups, cache["groups"])
    _, tail = _group_layout(cfg)
    tcache = []
    for p, kind, tc in zip(params.tail, tail, cache["tail"]):
        x, st = _decode_block(x, p, kind, cfg, ax, pos, tc, plan)
        tcache.append(st)
    x = L.norm(x, params.ln_f, cfg)
    logits = L.unembed(x, params.embed, cfg.vocab_size, ax)
    return logits[:, 0], {"groups": gcache, "tail": tcache}


def _roll(t, shift: int):
    """``torch.roll(t, shift, dims=1)`` as the two slices it moves (torch
    2.11's DTensor has no rule for ``roll``)."""
    n = t.shape[1]
    return torch.cat([t[:, n - shift:], t[:, :n - shift]], dim=1)


@L.serving
def prefill(params: HybridLM, tokens, cfg: ArchConfig, ax: MeshAxes = SINGLE,
            cache_len: int = 0):
    """Prompt pass. Fills the LRU and conv states and the window KV
    caches; returns (last logits, cache). The window cache holds the
    prompt's trailing ``window`` positions in ring layout (slot = pos %
    window); a prompt shorter than the window leaves an s-slot cache, as
    the reference's does."""
    x = _embed(params, tokens, cfg, ax)
    s = x.shape[1]
    x = constrain(x, res_spec(ax, s))
    positions = torch.arange(s, device=x.device)
    w = _cache_window(cfg, cache_len)
    pat = cfg.block_pattern

    def prefill_block(h, p: Block, kind: str):
        xn = L.norm(h, p.ln1, cfg)
        if kind == "rec":
            mix, st = rec_mix(xn, p.mix, cfg, ax)
        else:
            q, k, v = L.qkv_proj(xn, p.mix, cfg, ax, positions)
            o = L.attention_core_train(q, L.expand_kv(k, cfg), L.expand_kv(v, cfg), cfg, ax)
            mix = L.dense(o, p.mix.wo.w, getattr(p.mix.wo, "b", None))
            # ring-layout trailing window: roll so slot = pos % w
            shift = s % w
            st = {"k": _roll(k[:, -w:], shift).to(torch.bfloat16),
                  "v": _roll(v[:, -w:], shift).to(torch.bfloat16)}
        h = h + mix
        return h + L.mlp(L.norm(h, p.ln2, cfg), p.ffn, cfg, ax), st

    def group_body(h, gp, _gc):
        sts = {}
        for i, kind in enumerate(pat):
            h, sts[f"b{i}"] = prefill_block(h, getattr(gp, f"b{i}"), kind)
        return h, sts

    x, gcache = stack.scan_layers_with_cache(group_body, x, params.groups, None)
    _, tail = _group_layout(cfg)
    tcache = []
    for p, kind in zip(params.tail, tail):
        x, st = prefill_block(x, p, kind)
        tcache.append(st)
    x = L.norm(x, params.ln_f, cfg)
    logits = L.unembed(x[:, -1:], params.embed, cfg.vocab_size, ax)
    return logits[:, 0], {"groups": gcache, "tail": tcache}
