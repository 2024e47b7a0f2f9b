"""Mamba-1 selective SSM (falcon-mamba family): serving and training on
one card.

Prefill runs the whole prompt in ``fit_chunk(S, scan_chunk)`` chunks;
decode runs one token with the conv ring and the SSM state carried in
the cache. Both go through ``mamba_mix``, whose chunk body is
``_ssm_params`` and then the fused selective scan (K8,
``kernels.selective_scan``) from the carried state, in place of the
reference's associative scan and output einsum. On a CUDA tensor the
scan is the CUDA kernel; on a CPU tensor its plain torch version.

Training (``lm_loss``) runs the reference's own chunk body instead:
``_chunk_scan``, the associative scan of src/repro/models/mamba.py in
plain torch ops, then the output einsum. The reference trains through
``associative_scan`` too, never through the TPU kernel, which has no
backward; K8 has none either and refuses an operand that requires grad.
``mamba_mix`` takes ``_chunk_scan`` exactly when grad mode is on and the
input, the carried state or a parameter of the layer requires grad. It
is the reference's second path, not a fallback: prefill and decode run
under ``inference_mode`` (``no_grad`` on a mesh: ``layers.serving``) and
always launch K8. On a mesh the chunk loop runs on each rank's shard
(``_chunk_loop_shards``): K8 takes plain tensors.

Layouts are the reference's (src/repro/models/mamba.py): dense weights
``(d_in, d_out)`` applied as ``x @ w``, and the stacked cache
``{"conv": (L, B, d_conv - 1, d_inner) bf16, "ssm": (L, B, d_inner, N)
f32}``.
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
from repro_torch.models.shardings import (SINGLE, MeshAxes, P, ServePlan, constrain, distribute,
                                          is_dtensor, laid_out_as, placements)
from repro_torch.models.transformer import _on, chunked_xent, res_spec

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


def init_lm(cfg: ArchConfig, seed: int | None = 0, *, device=None,
            dtype=torch.bfloat16) -> MambaLM:
    return MambaLM(cfg, device=device, seed=seed, dtype=dtype)


def mamba_layer_specs(cfg: ArchConfig, ax: MeshAxes) -> dict:
    tp = ax.tp_if(cfg.d_inner)
    fs = ax.fsdp_if(cfg.d_model)
    return {
        "norm": {"scale": P(None)},
        "in_proj": {"w": P(fs, tp)},
        "conv_w": P(None, tp),
        "conv_b": P(tp),
        "x_proj": {"w": P(tp, None)},
        "dt_proj": {"w": P(None, tp), "b": P(tp)},
        "a_log": P(tp, None),
        "d_skip": P(tp),
        "out_proj": {"w": P(tp, fs)},
    }


def lm_specs(cfg: ArchConfig, ax: MeshAxes) -> dict:
    return {
        "embed": P(ax.tp_if(cfg.vocab_size), ax.fsdp_if(cfg.d_model)),
        "layers": stack.stacked_specs(mamba_layer_specs(cfg, ax)),
        "ln_f": {"scale": P(None)},
    }


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
        init_state = laid_out_as(torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                                             device=x.device), x)
    xp = torch.cat([init_state, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i : i + s] * conv_w[i].to(x.dtype) for i in range(k))
    # a copy: a view would keep the whole (B, S + K - 1, di) xp alive in
    # the stacked prefill state
    return y + conv_b.to(x.dtype), xp[:, -(k - 1):].clone()


def _ssm_params(u, w_x, w_dt, b_dt, a_log, cfg: ArchConfig, reduce=None):
    """u: (B, S, di) post-conv; the layer's ``x_proj.w``, ``dt_proj.w``,
    ``dt_proj.b`` and ``a_log``. Returns dA (B,S,di,N) f32, dBu (B,S,di,N)
    f32, C (B,S,N) f32, each contiguous. ``reduce`` (a rank's shard of
    d_inner) sums x_proj's partial product over the ranks."""
    n, r = cfg.ssm_state, cfg.dt_rank
    xdbc = L.dense(u, w_x)  # (B,S,r+2N)
    if reduce is not None:
        xdbc = reduce(xdbc)
    dt_r, bm, cm = xdbc.split([r, n, n], dim=-1)
    dt = F.softplus((L.dense(dt_r, w_dt) + b_dt).float())  # (B,S,di)
    a = -torch.exp(a_log.float())  # (di, N)
    da = torch.exp(dt[..., None] * a)  # (B,S,di,N)
    dbu = (dt * u.float())[..., None] * bm.float()[:, :, None, :]
    return da, dbu, cm.float().contiguous()


def _combine(x, y):
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, a2 * b1 + b2


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along axis 1 (a one longer, or equal)."""
    pairs = torch.stack([a[:, : b.shape[1]], b], dim=2).flatten(1, 2)
    return pairs if a.shape[1] == b.shape[1] else torch.cat([pairs, a[:, -1:]], dim=1)


def _associative_scan(da, db):
    """``jax.lax.associative_scan(_combine, (da, db), axis=1)`` with its
    own odd/even recursion: pairs combined, the half-length scan by
    recursion gives the odd elements, each even element is an odd one
    combined with the next input. The same association of products and
    sums as the reference, so float results stay close."""
    n = da.shape[1]
    if n < 2:
        return da, db
    odd = _associative_scan(*_combine((da[:, 0:-1:2], db[:, 0:-1:2]),
                                      (da[:, 1::2], db[:, 1::2])))
    prev = odd if n % 2 else (odd[0][:, :-1], odd[1][:, :-1])
    even = _combine(prev, (da[:, 2::2], db[:, 2::2]))
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip((da, db), even)]
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def _chunk_scan(da, dbu, h0):
    """Associative scan of h_t = da_t h_{t-1} + dbu_t within one chunk.
    da/dbu: (B, c, di, N) f32; h0: (B, di, N) f32. Returns (h_all, h_last)."""
    a_cum, b_cum = _associative_scan(da, dbu)
    h_all = b_cum + a_cum * h0[:, None]
    return h_all, h_all[:, -1]


def _chunk_loop(u, w_x, w_dt, b_dt, a_log, h, cfg: ArchConfig, train: bool, dtype,
                reduce=None):
    """The chunk loop of ``mamba_mix`` over u (B, S, di) post-conv from the
    carried state h (B, di, N) f32: each ``fit_chunk(S, scan_chunk)``
    chunk's ``_ssm_params``, then K8, or under grad ``_chunk_scan`` and
    the output einsum. Returns (y (B, S, di) in ``dtype``, h_last)."""
    s = u.shape[1]
    chunk = L.fit_chunk(s, cfg.scan_chunk)
    ys = []
    for c0 in range(0, s, chunk):
        da, dbu, cm = _ssm_params(u[:, c0 : c0 + chunk], w_x, w_dt, b_dt, a_log, cfg, reduce)
        if train:
            h_all, h = _chunk_scan(da, dbu, h)
            y = torch.einsum("bcdn,bcn->bcd", h_all, cm)
        else:
            y, h = selective_scan(da, dbu, cm, h0=h, return_state=True)
        ys.append(y.to(dtype))
    return torch.cat(ys, dim=1), h


def _chunk_loop_shards(u, p: MambaLayer, h, cfg: ArchConfig, ax: MeshAxes, train: bool,
                       dtype):
    """``_chunk_loop`` on DTensors, each rank on its own shard
    (``local_map``): the batch rows on the dp axes and d_inner on tp, as
    the reference's ``act`` spec lays them out, so K8 gets plain tensors
    and the loop dispatches no DTensor op. x_proj's product contracts
    the sharded d_inner: its partial sums are all-reduced over the tp
    axis each chunk, the reduction XLA inserts at the reference's
    ``x_proj`` (differentiable under grad). A weight's gradient on a
    rank covers only its batch rows: it is a partial sum over the dp
    axes."""
    import torch.distributed as dist
    from torch.distributed.nn import functional as dfn
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh, tp, dp = u.device_mesh, ax.tp_if(cfg.d_inner), ax.dp_if(u.shape[0])
    pl = lambda *spec: list(placements(P(*spec), mesh))
    act, state = pl(dp, None, tp), pl(dp, tp, None)
    if not is_dtensor(h):
        h = distribute(h, P(dp, tp, None), mesh)
    names = list(mesh.mesh_dim_names)
    group = None
    if tp is not None and mesh.size(names.index(tp)) > 1:
        group = mesh.get_group(tp)

    def reduce(t):
        if train:
            return dfn.all_reduce(t, group=group)
        dist.all_reduce(t, group=group)
        return t

    def local(u, w_x, w_dt, b_dt, a_log, h):
        return _chunk_loop(u, w_x, w_dt, b_dt, a_log, h, cfg, train, dtype,
                           None if group is None else reduce)

    dp_dims = {names.index(a) for a in dp}
    weights = (pl(tp, None), pl(None, tp), pl(tp), pl(tp, None))
    grads = tuple([Partial() if i in dp_dims else q for i, q in enumerate(w)] for w in weights)
    return local_map(local, out_placements=(act, state),
                     in_placements=(act, *weights, state),
                     in_grad_placements=(act, *grads, state),
                     device_mesh=mesh, redistribute_inputs=True)(
        u, p.x_proj.w, p.dt_proj.w, p.dt_proj.b, p.a_log, h)


def _needs_grad(x, p: MambaLayer, init_state) -> bool:
    if not torch.is_grad_enabled():
        return False
    carried = init_state.values() if init_state else ()
    return any(t.requires_grad for t in (x, *carried, *p.parameters()))


def mamba_mix(x, p: MambaLayer, cfg: ArchConfig, ax: MeshAxes = SINGLE, init_state=None):
    """The Mamba mixer. x: (B, S, d_model) -> (B, S, d_model), and the
    new state {conv, ssm}. init_state: None (a fresh prompt) or
    dict(conv, ssm) carried from the previous call. Under grad (see the
    module docstring) each chunk runs ``_chunk_scan`` and the output
    einsum; otherwise K8."""
    train = _needs_grad(x, p, init_state)
    b, s, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    act = P(ax.dp_if(b), None, ax.tp_if(di))
    xz = constrain(L.dense(x, p.in_proj.w), act)  # (B,S,2di)
    u, z = xz.split(di, dim=-1)
    conv0 = init_state["conv"] if init_state else None
    u, conv_state = _causal_conv(u, p.conv_w, p.conv_b, conv0)
    conv_state = constrain(conv_state, act)
    u = constrain(F.silu(u), act)

    h = init_state["ssm"] if init_state else torch.zeros((b, di, n), dtype=torch.float32,
                                                         device=x.device)
    if is_dtensor(u):
        y, h = _chunk_loop_shards(u, p, h, cfg, ax, train, x.dtype)
    else:
        y, h = _chunk_loop(u, p.x_proj.w, p.dt_proj.w, p.dt_proj.b, p.a_log, h, cfg, train,
                           x.dtype)
    y = y + u * p.d_skip.to(u.dtype)
    y = constrain(y * F.silu(z), act)
    out = L.dense(y, p.out_proj.w)
    return out, {"conv": conv_state, "ssm": h}


def apply_mamba_layer(x, p: MambaLayer, cfg: ArchConfig, ax: MeshAxes = SINGLE):
    y, _ = mamba_mix(L.norm(x, p.norm, cfg), p, cfg, ax)
    return x + y


# ---------------------------------------------------------------------------
# LM entry points
# ---------------------------------------------------------------------------


def lm_loss(params: MambaLM, batch: dict, cfg: ArchConfig, ax: MeshAxes = SINGLE):
    """Mean next-token cross-entropy of ``batch`` (tokens, labels, and an
    optional loss_mask, each (B, S)): embedding, the layers with
    per-layer remat, ``ln_f``, and ``chunked_xent`` against the tied
    embedding."""
    x = L.embed_tokens(params.embed, batch["tokens"], ax)
    x = constrain(x, res_spec(ax, x.shape[1]))

    def body(h, lp):
        return apply_mamba_layer(h, lp, cfg, ax)

    x = stack.scan_layers(body, x, params.layers)
    x = L.norm(x, params.ln_f, cfg)
    mask = batch.get("loss_mask")
    return chunked_xent(x, params.embed, _on(batch["labels"], x.device), cfg, ax,
                        None if mask is None else _on(mask, x.device))


def cache_specs(cfg: ArchConfig, ax: MeshAxes, batch: int, plan: ServePlan) -> dict:
    b = plan.batch_axes or None
    tp = ax.tp_if(cfg.d_inner)
    return {
        "conv": P(None, b, None, tp),
        "ssm": P(None, b, tp, None),
    }


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


@L.serving
def prefill(params: MambaLM, tokens, cfg: ArchConfig, ax: MeshAxes = SINGLE,
            cache_len: int = 0):
    """Run the full prompt, returning last-token logits (B, vocab) and the
    decode state stacked over layers."""
    x = L.embed_tokens(params.embed, tokens, ax)
    x = constrain(x, res_spec(ax, x.shape[1]))
    x, states = _run_layers(params, x, cfg, ax, None)
    logits = L.unembed(x[:, -1:], params.embed, cfg.vocab_size, ax)
    return logits[:, 0], states


@L.serving
def decode_step(params: MambaLM, token, cache, pos, cfg: ArchConfig, ax: MeshAxes = SINGLE,
                plan: ServePlan | None = None):
    """Single-token decode: conv ring shift + one recurrence step. token
    (B, 1); ``pos`` is unused (the state carries the position)."""
    x = L.embed_tokens(params.embed, token, ax)  # (B,1,D)
    x, new_cache = _run_layers(params, x, cfg, ax, cache)
    logits = L.unembed(x, params.embed, cfg.vocab_size, ax)
    return logits[:, 0], new_cache
