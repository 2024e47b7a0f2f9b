"""Mamba-1 selective SSM (falcon-mamba family), for serving on one card.

Prefill runs the whole prompt in ``fit_chunk(S, scan_chunk)`` chunks;
decode runs one token with the conv ring and the SSM state carried in
the cache. Both go through ``mamba_mix``, whose chunk body is
``_ssm_params`` and then the fused selective scan (K8,
``kernels.selective_scan``) from the carried state, in place of the
reference's associative scan and output einsum. On a CUDA tensor the
scan is the CUDA kernel; on a CPU tensor its plain torch version.

Layouts are the reference's (src/repro/models/mamba.py): dense weights
``(d_in, d_out)`` applied as ``x @ w``, and the stacked cache
``{"conv": (L, B, d_conv - 1, d_inner) bf16, "ssm": (L, B, d_inner, N)
f32}``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models import layers as L
from repro_torch.models import stack
from repro_torch.models.shardings import SINGLE, MeshAxes, ServePlan

# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class MambaLayer(nn.Module):
    """One mixer layer; attribute names follow the reference's tree."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None, dtype, device):
        super().__init__()
        d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
        f32 = dict(dtype=torch.float32, device=device)
        self.norm = L.init_norm(cfg, d, device)
        self.in_proj = L.init_dense(gen, d, 2 * di, False, dtype, device)
        self.conv_w = L.param(L.draw(gen, (cfg.d_conv, di), 1.0 / math.sqrt(cfg.d_conv),
                                     dtype, device))
        self.conv_b = L.param(torch.zeros((di,), **f32))
        self.x_proj = L.init_dense(gen, di, r + 2 * n, False, dtype, device)
        self.dt_proj = L.init_dense(gen, r, di, True, dtype, device)
        # S4D-real init for A; dt bias init for softplus ~ [1e-3, 1e-1]
        self.a_log = L.param(torch.log(torch.arange(1, n + 1, **f32)).expand(di, n).clone())
        if gen is not None:
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt_init = torch.exp(torch.rand((di,), generator=gen, **f32) * (hi - lo) + lo)
            self.dt_proj.b.copy_(dt_init + torch.log(-torch.expm1(-dt_init)))  # inverse softplus
        self.d_skip = L.param(torch.ones((di,), **f32))
        self.out_proj = L.init_dense(gen, di, d, False, dtype, device)


class MambaLM(nn.Module):
    """The ssm-family LM: ``embed`` (vocab, d_model), tied as the output
    head; ``layers``; ``ln_f``.

    ``device=None`` is the card (raises without one); ``"cpu"`` only
    when asked. Weights are drawn from a ``torch.Generator`` on the
    device seeded with ``seed``; ``seed=None`` leaves them uninitialised
    for ``models.convert`` to replace."""

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int | None = 0,
                 dtype=torch.bfloat16):
        super().__init__()
        dev = resolve_device(device)
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        self.embed = L.init_embed(gen, cfg, dtype, dev)
        self.layers = stack.stacked_init(lambda: MambaLayer(cfg, gen, dtype, dev),
                                         cfg.num_layers)
        self.ln_f = L.init_norm(cfg, cfg.d_model, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_lm(cfg: ArchConfig, seed: int = 0, *, device=None, dtype=torch.bfloat16) -> MambaLM:
    return MambaLM(cfg, device=device, seed=seed, dtype=dtype)


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------


def _causal_conv(x, conv_w, conv_b, init_state=None):
    """Depthwise causal conv as the reference's shifted sum (not
    ``nn.Conv1d``, which runs float32 in TF32 on the card). x: (B, S, di);
    conv_w: (K, di); init_state: (B, K-1, di) carried from the previous
    chunk (zeros at t=0). Returns (y (B, S, di), new_state (B, K-1, di)),
    in the promoted dtype of x and the state, as in the reference."""
    k = conv_w.shape[0]
    if init_state is None:
        init_state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([init_state, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i : i + s] * conv_w[i].to(x.dtype) for i in range(k))
    # a copy: a view would keep the whole (B, S + K - 1, di) xp alive in
    # the stacked prefill state
    return y + conv_b.to(x.dtype), xp[:, -(k - 1):].clone()


def _ssm_params(u, p: MambaLayer, cfg: ArchConfig):
    """u: (B, S, di) post-conv. Returns dA (B,S,di,N) f32, dBu (B,S,di,N)
    f32, C (B,S,N) f32, each contiguous."""
    n, r = cfg.ssm_state, cfg.dt_rank
    xdbc = L.dense(u, p.x_proj.w)  # (B,S,r+2N)
    dt_r, bm, cm = xdbc.split([r, n, n], dim=-1)
    dt = F.softplus((L.dense(dt_r, p.dt_proj.w) + p.dt_proj.b).float())  # (B,S,di)
    a = -torch.exp(p.a_log.float())  # (di, N)
    da = torch.exp(dt[..., None] * a)  # (B,S,di,N)
    dbu = (dt * u.float())[..., None] * bm.float()[:, :, None, :]
    return da, dbu, cm.float().contiguous()


def mamba_mix(x, p: MambaLayer, cfg: ArchConfig, ax: MeshAxes = SINGLE, init_state=None):
    """The Mamba mixer. x: (B, S, d_model) -> (B, S, d_model), and the
    new state {conv, ssm}. init_state: None (a fresh prompt) or
    dict(conv, ssm) carried from the previous call."""
    b, s, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    xz = L.dense(x, p.in_proj.w)  # (B,S,2di)
    u, z = xz.split(di, dim=-1)
    conv0 = init_state["conv"] if init_state else None
    u, conv_state = _causal_conv(u, p.conv_w, p.conv_b, conv0)
    u = F.silu(u)

    chunk = L.fit_chunk(s, cfg.scan_chunk)
    h = init_state["ssm"] if init_state else torch.zeros((b, di, n), dtype=torch.float32,
                                                         device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        da, dbu, cm = _ssm_params(u[:, c0 : c0 + chunk], p, cfg)
        y, h = selective_scan(da, dbu, cm, h0=h, return_state=True)
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1)
    y = y + u * p.d_skip.to(u.dtype)
    y = y * F.silu(z)
    out = L.dense(y, p.out_proj.w)
    return out, {"conv": conv_state, "ssm": h}


# ---------------------------------------------------------------------------
# LM entry points
# ---------------------------------------------------------------------------


class TensorSpec(NamedTuple):
    """Shape and dtype of one cache leaf (the reference's ShapeDtypeStruct)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def cache_shape(cfg: ArchConfig, batch: int, cache_len: int = 0) -> dict[str, TensorSpec]:
    di, n, k = cfg.d_inner, cfg.ssm_state, cfg.d_conv
    return {
        "conv": TensorSpec((cfg.num_layers, batch, k - 1, di), torch.bfloat16),
        "ssm": TensorSpec((cfg.num_layers, batch, di, n), torch.float32),
    }


def init_cache(cfg: ArchConfig, batch: int, cache_len: int = 0, *, device=None) -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
            for k, spec in cache_shape(cfg, batch, cache_len).items()}


def _run_layers(params: MambaLM, x, cfg: ArchConfig, ax: MeshAxes, cache):
    def body(h, lp, lc):
        y, st = mamba_mix(L.norm(h, lp.norm, cfg), lp, cfg, ax, init_state=lc)
        return h + y, st

    x, states = stack.scan_layers_with_cache(body, x, params.layers, cache)
    return L.norm(x, params.ln_f, cfg), states


@torch.inference_mode()
def prefill(params: MambaLM, tokens, cfg: ArchConfig, ax: MeshAxes = SINGLE,
            cache_len: int = 0):
    """Run the full prompt, returning last-token logits (B, vocab) and the
    decode state stacked over layers."""
    x = L.embed_tokens(params.embed, tokens)
    x, states = _run_layers(params, x, cfg, ax, None)
    logits = L.unembed(x[:, -1:], params.embed, cfg.vocab_size)
    return logits[:, 0], states


@torch.inference_mode()
def decode_step(params: MambaLM, token, cache, pos, cfg: ArchConfig, ax: MeshAxes = SINGLE,
                plan: ServePlan | None = None):
    """Single-token decode: conv ring shift + one recurrence step. token
    (B, 1); ``pos`` is unused (the state carries the position)."""
    x = L.embed_tokens(params.embed, token)  # (B,1,D)
    x, new_cache = _run_layers(params, x, cfg, ax, cache)
    logits = L.unembed(x, params.embed, cfg.vocab_size)
    return logits[:, 0], new_cache
