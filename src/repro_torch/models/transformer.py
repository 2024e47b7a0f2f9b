"""Decoder-LM pieces shared across families (src/repro/models/transformer.py).

Only ``chunked_xent`` is ported so far: the ssm family's loss ends in it.
The rest of the reference file (decoder layers, attention, the dense and
vlm ``lm_loss`` / ``prefill`` / ``decode_step``) waits for the dense
family (ROADMAP queue 1). The reference's ``res_spec`` pins the residual
stream's sharding on a mesh; on one card there is nothing to pin.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.shardings import SINGLE, MeshAxes


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
