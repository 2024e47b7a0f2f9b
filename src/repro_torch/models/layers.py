"""Shared model primitives the Mamba path uses: norms, dense projections,
chunk fitting, embeddings.

Parameters are ``nn.Module``s whose attributes carry the JAX package's
names (``norm.scale``, ``in_proj.w``), so a state dict key is the
reference's tree path. Layouts are the reference's: a dense weight is
``(d_in, d_out)`` and is applied as ``x @ w``; an embedding is
``(vocab, d_model)``. Weights are bf16 by default, norm scales f32; the
arithmetic follows the reference's dtype promotion (a bf16 activation
plus an f32 bias is f32). Attention and MLPs wait for the dense family.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig


def param(t: torch.Tensor) -> nn.Parameter:
    """A serving parameter: no gradient."""
    return nn.Parameter(t, requires_grad=False)


def draw(gen: torch.Generator | None, shape, scale: float, dtype, device) -> torch.Tensor:
    """Standard normal * ``scale`` drawn in f32 on ``device`` from
    ``gen``, cast to ``dtype``; left uninitialised when ``gen`` is None
    (the tensor is about to be replaced by converted weights)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    out = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (out * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    v = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(v + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class Norm(nn.Module):
    """``scale`` (and ``bias`` for layernorm), f32."""

    def __init__(self, cfg: ArchConfig, d: int, device):
        super().__init__()
        self.scale = param(torch.ones((d,), dtype=torch.float32, device=device))
        if cfg.norm == "layernorm":
            self.bias = param(torch.zeros((d,), dtype=torch.float32, device=device))


def norm(x: torch.Tensor, p: Norm, cfg: ArchConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p.scale, p.bias, cfg.norm_eps)
    return rmsnorm(x, p.scale, cfg.norm_eps)


def init_norm(cfg: ArchConfig, d: int, device) -> Norm:
    return Norm(cfg, d, device)


# ---------------------------------------------------------------------------
# dense projections
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """``w`` (d_in, d_out), and an f32 bias ``b`` when asked."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = param(w)
        if b is not None:
            self.b = param(b)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def init_dense(gen, d_in: int, d_out: int, bias: bool, dtype=torch.bfloat16,
               device=None) -> Dense:
    w = draw(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype, device)
    b = torch.zeros((d_out,), dtype=torch.float32, device=device) if bias else None
    return Dense(w, b)


def fit_chunk(s: int, want: int) -> int:
    """Largest chunk <= want that divides s."""
    c = max(1, min(want, s))
    while s % c:
        c -= 1
    return c


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def init_embed(gen, cfg: ArchConfig, dtype=torch.bfloat16, device=None) -> nn.Parameter:
    return param(draw(gen, (cfg.vocab_size, cfg.d_model), 0.02, dtype, device))


def embed_tokens(embed: torch.Tensor, tokens) -> torch.Tensor:
    """tokens (B, S) ints (a tensor, or a numpy array moved to the
    embedding's device) -> (B, S, d_model) in the embedding's dtype."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens, dtype=np.int64))
    return nn.functional.embedding(tokens.to(embed.device, torch.long), embed)


def unembed(x: torch.Tensor, embed_or_head: torch.Tensor, vocab: int) -> torch.Tensor:
    """Logits in x's dtype; a (vocab, d) weight is the tied embedding."""
    w = embed_or_head.to(x.dtype)
    return x @ (w.T if w.shape[0] == vocab else w)
