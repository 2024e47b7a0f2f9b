"""Cases shared by tests/test_torch_models.py,
tests/test_torch_model_grads.py and tests/test_torch_loss_paths.py: the
ported ids at ``reduced()``, the numpy-seeded batch for both packages,
the reference's ``init`` drawn once per process, the loss and gradient
runs of both packages, the cache trees as flat leaves, and the checks
and tolerances those files state.

The encdec reference in float32: the reference's ``encode`` casts the
frames to bf16, so with float32 weights its first layer's residual
promotes to float32 and its ``lax.scan`` raises ``TypeError`` (the carry
changes dtype). ``reference`` then swaps in ``unrolled_encode``, the
same layer body applied layer by layer, and runs the reference op by op
rather than under ``jit``: XLA's excess-precision rewrite would skip the
bf16 rounding of that first layer's layernorm output, which the port and
the reference's own ops both make. Everything else of the reference
(the decoder, the cross-attention, the cache, ``chunked_xent``) is its
own code."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
import repro.models.encdec as jencdec
import repro.models.layers as jlayers
import repro.models.moe as jmoe
from repro.models.registry import get_model as jax_get_model
from repro.models.shardings import SINGLE as JSINGLE
from repro_torch import configs
from repro_torch.models import convert, moe
from repro_torch.models.registry import get_model
from repro_torch.models.shardings import SINGLE
from repro_torch.models.stack import tree_map

PORTED_IDS = ("falcon_mamba_7b", "qwen2_72b", "mistral_large_123b", "starcoder2_15b",
              "command_r_35b", "pixtral_12b", "olmoe_1b_7b", "granite_moe_3b_a800m",
              "recurrentgemma_9b", "seamless_m4t_large_v2")
B, S, CACHE_LEN = 2, 64, 128
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL = {"ssm": 4e-2, "dense": 2e-2, "vlm": 2e-2, "moe": 2e-2, "hybrid": 4e-2,
            "encdec": 2e-2}
FLIP_SHARE = 1e-3


def cfgs(case: str):
    """(port config, reference config) of a case: ``arch`` at
    ``reduced()``, or ``mistral_large_123b/8L-block2``."""
    arch, _, variant = case.partition("/")
    kw = dict(num_layers=8, remat_block=2) if variant else {}
    return configs.get_config(arch).reduced(**kw), jconfigs.get_config(arch).reduced(**kw)


def batch(cfg, seed: int = 0):
    """(port batch, reference batch) from one numpy generator."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    port = {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(np.roll(tokens, -1, axis=1))}
    if cfg.family in ("vlm", "encdec"):
        pe = rng.standard_normal((B, cfg.num_stub_tokens, cfg.d_model)).astype(np.float32)
        key = "patch_embed" if cfg.family == "vlm" else "src_embed"
        port[key] = torch.from_numpy(pe).to(torch.bfloat16)
    ref = {k: jnp.asarray(v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy(),
                          jnp.bfloat16 if v.dtype == torch.bfloat16 else None)
           for k, v in port.items()}
    return port, ref


def prefix_len(cfg) -> int:
    """Positions before the first token: the vlm's stub prefix (the
    encdec's frames are the encoder's, not the decoder's)."""
    return cfg.num_stub_tokens if cfg.family == "vlm" else 0


def unrolled_encode(params, src_embed, cfg, ax):
    """The reference's ``encode`` with its layer scan unrolled."""
    t, d = src_embed.shape[1:]
    x = (src_embed.astype(jnp.bfloat16)
         + jencdec.sinusoid(jnp.arange(t), d)[None].astype(jnp.bfloat16))
    for i in range(cfg.enc_layers):
        lp = jax.tree.map(lambda a, i=i: a[i], params["enc"])
        x = x + jlayers.attention_train(jlayers.norm(x, lp["ln1"], cfg), lp["attn"], cfg, ax,
                                        None, bidirectional=True)
        x = x + jlayers.mlp(jlayers.norm(x, lp["ln2"], cfg), lp["ffn"], cfg, ax)
    return jlayers.norm(x, params["ln_enc"], cfg)


@contextlib.contextmanager
def reference(cfg_j, dtype: str):
    """While open, how to run the reference's functions for ``cfg_j``
    in ``dtype``: ``jax.jit``, or for encdec in float32 op by op with
    ``unrolled_encode`` in place of ``encode`` (see the module
    docstring)."""
    if cfg_j.family != "encdec" or dtype != "float32":
        yield jax.jit
        return
    real = jencdec.encode
    jencdec.encode = unrolled_encode
    try:
        yield lambda fn: fn
    finally:
        jencdec.encode = real


def to_torch(tree):
    """A tree of the reference's arrays as CPU tensors, same structure."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@functools.lru_cache(maxsize=None)
def ref_init(case: str):
    """The reference's ``init`` of a case, drawn once for the module."""
    cfg_j = cfgs(case)[1]
    return jax_get_model(cfg_j).init(cfg_j, jax.random.PRNGKey(0))


def ref_params(case: str, dtype: str):
    p = ref_init(case)
    if dtype == "float32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    return p


def to_np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def bf16_neighbours(got: torch.Tensor, want) -> np.ndarray:
    """Elements where two bf16 tensors are adjacent bf16 values."""
    g = got.to(torch.bfloat16).view(torch.int16).int()
    w = torch.from_numpy(np.asarray(want, np.float32)).to(torch.bfloat16).view(torch.int16).int()
    return ((g - w).abs() == 1).numpy()


def assert_f32_close(got, want, *, bf16_leaf: bool = False):
    """rtol = atol = 1e-4; a bf16 leaf may also hold one-ulp neighbours
    of the reference's values, in at most ``FLIP_SHARE`` of its elements."""
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape
    bad = np.abs(g - w) > F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(w)
    if bf16_leaf:
        flips = bad & bf16_neighbours(got, want)
        assert flips.sum() <= FLIP_SHARE * g.size, (int(flips.sum()), g.size)
        bad &= ~flips
    assert not bad.any(), (int(bad.sum()), float(np.abs(g - w).max()))


def assert_bf16_close(got, want, rel: float = BF16_REL["dense"], held=None):
    """max |got - want| <= rel * max |want| over the elements ``held``
    (a mask that broadcasts against the tensors' leading axes; all when
    None); every element of ``got`` finite."""
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    if held is not None:
        held = np.broadcast_to(held.reshape(held.shape + (1,) * (g.ndim - held.ndim)), g.shape)
        g, w = g[held], w[held]
        if not g.size:
            return
    assert np.abs(g - w).max() <= rel * np.abs(w).max(), np.abs(g - w).max()


# -- moe routing --------------------------------------------------------------

ROUTE_FLIP_SHARE = 0.05  # of a step's routed tokens, over its layers
ROUTE_MARGIN = 2.0 ** -6  # of the logits' magnitude: four bf16 ulps


@contextlib.contextmanager
def recorded_routes():
    """While open, each package's ``moe.route`` records, call by call (one
    call a layer, in order), the expert indices (B, S, kk) and router
    logits (B, S, E) it routed by: ``{"port": [...], "ref": [...]}``.
    The reference's record comes from ``jax.debug.callback`` (ordered),
    so it holds under ``jit`` and ``scan``; a function traced while open
    keeps recording, so trace the reference's steps inside it."""
    rec = {"port": [], "ref": []}
    real_port, real_ref = moe.route, jmoe.route

    def port_route(x, w, cfg):
        out = real_port(x, w, cfg)
        logits = moe.L.einsum_f32("bsd,de->bse", x, w.to(x.dtype))
        rec["port"].append((out[1].numpy(), logits.numpy()))
        return out

    def ref_route(x, w, cfg):
        out = real_ref(x, w, cfg)
        logits = jmoe.L.einsum_f32("bsd,de->bse", x, w.astype(x.dtype))
        jax.debug.callback(lambda i, lg: rec["ref"].append((np.asarray(i), np.asarray(lg))),
                           out[1], logits, ordered=True)
        return out

    moe.route, jmoe.route = port_route, ref_route
    try:
        yield rec
    finally:
        moe.route, jmoe.route = real_port, real_ref


def route_flip_mask(rec) -> list[np.ndarray]:
    """Per layer, a (B, S) mask of the tokens whose set of experts differs
    between the packages (the order of a token's choices does not
    matter: its experts are distinct, so no capacity rank moves)."""
    jax.effects_barrier()
    assert len(rec["port"]) == len(rec["ref"])
    return [(np.sort(pi, -1) != np.sort(ri, -1)).any(-1)
            for (pi, _), (ri, _) in zip(rec["port"], rec["ref"])]


def route_flips(rec) -> list[int]:
    """Per layer, the number of tokens whose set of experts differs."""
    return [int(m.sum()) for m in route_flip_mask(rec)]


def prefill_reach(masks: list[np.ndarray], num_layers: int, b: int, s: int, cache_len: int):
    """Where a prefill's routing differences (per layer a (B, S) mask;
    none recorded for a family without moe layers) can reach, by causality:
    (cache mask (L, B, T), logits mask (B,)). A token routed otherwise
    at layer l, position t changes layer l's output at t and, through
    the capacity ranks (a cumsum over the row's tokens in order), at
    the row's later positions; attention carries that to every later
    position of the layers above. Layer l's cache reads layer l's input."""
    masks = masks or [np.zeros((b, s), bool)] * num_layers
    t = np.arange(cache_len)
    first = np.full(b, cache_len)  # earliest position reached in a layer's input
    cache = np.zeros((num_layers, b, cache_len), bool)
    for layer, m in enumerate(masks):
        cache[layer] = (t[None] >= first[:, None]) & (t[None] < s)
        first = np.minimum(first, np.where(m.any(1), m.argmax(1), cache_len))
    return cache, first < cache_len


def decode_reach(masks: list[np.ndarray], cache: np.ndarray, pos: int):
    """``prefill_reach`` for a one-token decode at ``pos`` from a cache
    reached where ``cache`` says: the new cache mask and the logits mask
    (B,). A layer's input at a row is reached once a layer below it read
    a reached cache row or routed that token otherwise."""
    new = cache.copy()
    row = np.zeros(cache.shape[1], bool)
    for layer, m in enumerate(masks or [np.zeros((cache.shape[1], 1), bool)] * len(cache)):
        new[layer, :, pos] = row
        row = row | cache[layer].any(-1) | m[:, 0]
    return new, row


def first_flip_margins(rec) -> list[float]:
    """At the first layer whose routing differs (none: ``[]``): for each token whose
    expert set differs, the gap between the port's k-th choice and the
    reference's best expert the port left out, in the port's own logits,
    over the logits' magnitude there (0 for an exact tie)."""
    flips = route_flips(rec)
    layer = next((i for i, n in enumerate(flips) if n), None)
    if layer is None:
        return []
    (pi, logits), (ri, _) = rec["port"][layer], rec["ref"][layer]
    out = []
    for b, s in zip(*np.nonzero((np.sort(pi, -1) != np.sort(ri, -1)).any(-1))):
        left_out = [e for e in ri[b, s] if e not in pi[b, s]]
        kth = logits[b, s, pi[b, s, -1]]
        out.append(float((kth - max(logits[b, s, e] for e in left_out)) / abs(kth)))
    return out


# -- loss and gradients -------------------------------------------------------


def loss_and_grads(case: str):
    """(port loss, ref loss, port gradient tree, ref gradient tree) of a
    case in float32."""
    cfg, cfg_j = cfgs(case)
    p = ref_params(case, "float32")
    port_batch, ref_batch = batch(cfg)
    api_j = jax_get_model(cfg_j)
    with reference(cfg_j, "float32") as run:
        jloss, jgrads = run(jax.value_and_grad(
            lambda p, b: api_j.loss(p, b, cfg_j, JSINGLE)))(p, ref_batch)
    model = convert.from_jax(jax.tree.map(np.asarray, p), cfg, device="cpu", trainable=True)
    loss = get_model(cfg).loss(model, port_batch, cfg, SINGLE)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), float(jloss), convert.stacked_tree(model, grads), jgrads


def assert_loss_matches(run):
    loss, jloss, _, _ = run
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, **F32_TOL)


def assert_every_gradient_leaf_matches(run):
    """Each of the reference's gradient leaves within 1e-3 of its max
    |ref|, and no port leaf left over."""
    _, _, grads, jgrads = run
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(jax.tree.leaves(grads))
    for path, ref in flat:
        port = grads
        for k in path:
            port = port[k.key if hasattr(k, "key") else k.idx]
        ref = np.asarray(ref, np.float32)
        err = np.abs(port.float().numpy() - ref).max()
        assert err <= 1e-3 * np.abs(ref).max() + 1e-12, (jax.tree_util.keystr(path), err)
