"""The dense family's modules against the JAX package's, one by one:
``rope``, ``expand_kv``, ``mlp``, ``attention_train``,
``attention_decode_general``, ``prefill``'s cache length, the vlm prefix,
tied and untied heads, the two-level remat of ``stack.scan_layers`` and
``convert.from_jax`` / ``to_reference_tree``.

Inputs come from seeded numpy generators and go to both packages. In
float32 every module is held to rtol = atol = 1e-5 (only the order of
float32 sums differs; ``mlp`` at that tolerance also tells the tanh
``gelu`` of ``jax.nn.gelu`` from the exact erf form, which differ by up
to 1e-3), whole models to 1e-4, bf16 leaves of a cache also to their
one-ulp neighbours (see tests/test_torch_models.py). Weight conversion
and the layer remat are bit for bit.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import stack as jstack  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.shardings import SINGLE as JSINGLE  # noqa: E402
from repro.models.shardings import ServePlan as JServePlan  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, stack  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.shardings import SINGLE, ServePlan  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
DENSE_IDS = ("qwen2_72b", "mistral_large_123b", "starcoder2_15b", "command_r_35b",
             "pixtral_12b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str, **kw):
    return configs.get_config(arch).reduced(**kw), jconfigs.get_config(arch).reduced(**kw)


def _randn(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **tol)


def _f32_params(cfg_j, seed: int = 0):
    return jax.tree.map(lambda a: a.astype(jnp.float32),
                        JT.init_lm(cfg_j, jax.random.PRNGKey(seed)))


def _layer0(cfg, cfg_j):
    """Layer 0 of an f32 model: (port DecoderLayer, reference tree)."""
    p = _f32_params(cfg_j)
    model = convert.from_jax(jax.tree.map(np.asarray, p), cfg, device="cpu")
    return model.layers[0], jax.tree.map(lambda a: a[0], p["layers"])


# -- rope, expand_kv ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos_dims", [1, 2])
def test_rope(pos_dims, dtype):
    x = _randn(0, 2, 9, 4, 32)
    if pos_dims == 1:
        positions = np.arange(3, 12, dtype=np.int32)
    else:
        positions = np.random.default_rng(1).integers(0, 5000, (2, 9), dtype=np.int32)
    jx = jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = JL.rope(jx, jnp.asarray(positions), 1e6)
    got = L.rope(tx, torch.from_numpy(positions), 1e6)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    # angles up to 5000 rad: cos/sin agree to ~5e-4 of an f32 ulp of the angle
    _close(got, want, TOL if dtype == "float32" and pos_dims == 1 else
           dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=1e-3, atol=1e-3))


@pytest.mark.parametrize("kv,heads", [(4, 4), (1, 4), (2, 8)])
def test_expand_kv_repeats_each_head_over_its_group(kv, heads):
    cfg, cfg_j = _cfgs("qwen2_72b", num_heads=heads, num_kv_heads=kv)
    k = _randn(2, 2, 5, kv, 8)
    got = L.expand_kv(torch.from_numpy(k), cfg)
    want = np.asarray(JL.expand_kv(jnp.asarray(k), cfg_j))
    np.testing.assert_array_equal(got.numpy(), want)
    g = heads // kv
    for h in range(heads):
        np.testing.assert_array_equal(got[:, :, h].numpy(), k[:, :, h // g])


# -- mlp ----------------------------------------------------------------------


@pytest.mark.parametrize("act", ["gelu", "silu", "gelu_gated"])
def test_mlp_activations(act):
    cfg, cfg_j = _cfgs("starcoder2_15b", act=act)
    layer, lp = _layer0(cfg, cfg_j)
    x = _randn(3, 2, 7, cfg.d_model) * 2
    # nonzero biases, so that the bias path is held too
    if act == "gelu":
        for name in ("wi", "wd"):
            b = _randn(4, *lp["ffn"][name]["b"].shape)
            lp["ffn"][name]["b"] = jnp.asarray(b)
            getattr(layer.ffn, name).b.copy_(torch.from_numpy(b))
    want = JL.mlp(jnp.asarray(x), lp["ffn"], cfg_j, JSINGLE)
    got = L.mlp(torch.from_numpy(x), layer.ffn, cfg, SINGLE)
    _close(got, want)


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    got = L._gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))), **TOL)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - got).max() > 1e-4  # the trap this guards against


# -- attention ----------------------------------------------------------------


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("arch", ["starcoder2_15b", "qwen2_72b"])
def test_attention_train(arch, bidirectional):
    cfg, cfg_j = _cfgs(arch, sliding_window=16 if arch == "starcoder2_15b" else None,
                       attn_chunk=8)
    layer, lp = _layer0(cfg, cfg_j)
    for name in ("wq", "wk", "wv"):
        if cfg.qkv_bias:
            b = _randn(5, *lp["attn"][name]["b"].shape)
            lp["attn"][name]["b"] = jnp.asarray(b)
            getattr(layer.attn, name).b.copy_(torch.from_numpy(b))
    x = _randn(6, 2, 40, cfg.d_model)
    want = JL.attention_train(jnp.asarray(x), lp["attn"], cfg_j, JSINGLE,
                              bidirectional=bidirectional)
    got = L.attention_train(torch.from_numpy(x), layer.attn, cfg, SINGLE,
                            bidirectional=bidirectional)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("pos", [3, 11, 12, 29])
def test_attention_decode_general(pos, window):
    """A 12-slot ring: pos 3 and 11 before it wraps, 12 and 29 after (the
    write lands on slot pos % 12); float32 caches, so every step of the
    decode is float32. The input caches stay as they were."""
    cfg, cfg_j = _cfgs("mistral_large_123b", sliding_window=window, num_heads=8,
                       num_kv_heads=2)
    layer, lp = _layer0(cfg, cfg_j)
    x1 = _randn(7, 2, 1, cfg.d_model)
    ck, cv = _randn(8, 2, 12, 2, cfg.head_dim), _randn(9, 2, 12, 2, cfg.head_dim)
    want = JL.attention_decode_general(jnp.asarray(x1), jnp.asarray(ck), jnp.asarray(cv),
                                       lp["attn"], cfg_j, JSINGLE, jnp.asarray(pos),
                                       JServePlan())
    tck, tcv = torch.from_numpy(ck), torch.from_numpy(cv)
    got = L.attention_decode_general(torch.from_numpy(x1), tck, tcv, layer.attn, cfg, SINGLE,
                                     pos, ServePlan())
    for g, w in zip(got, want, strict=True):
        _close(g, w)
    assert np.array_equal(tck.numpy(), ck) and np.array_equal(tcv.numpy(), cv)
    changed = np.nonzero((got[1].numpy() != ck).any(axis=(0, 2, 3)))[0]
    assert changed.tolist() == [pos % 12]


def test_sequence_sharded_decode_waits_for_the_mesh_slice():
    """Its slice has come (tests/test_torch_mesh_train.py holds it on 4
    ranks against the reference); a sequence-sharded plan takes the
    caches as DTensors on their mesh, and refuses plain tensors."""
    cfg, cfg_j = _cfgs("qwen2_72b")
    layer, _ = _layer0(cfg, cfg_j)
    cache = torch.zeros(1, 8, cfg.num_kv_heads, cfg.head_dim)
    with pytest.raises(TypeError, match="DTensors"):
        L.attention_decode_general(torch.zeros(1, 1, cfg.d_model), cache, cache, layer.attn,
                                   cfg, SINGLE, 0, ServePlan(seq_axes=("model",)))


# -- prefill, prefix, heads ---------------------------------------------------


def _bf16_neighbours(got: torch.Tensor, want) -> np.ndarray:
    g = got.to(torch.bfloat16).view(torch.int16).int()
    w = torch.from_numpy(np.asarray(want, np.float32)).to(torch.bfloat16).view(torch.int16).int()
    return ((g - w).abs() == 1).numpy()


def _close_bf16_cache(got, want):
    """MODEL_TOL, or a one-ulp bf16 neighbour in at most 1e-3 of the
    elements (see tests/test_torch_models.py)."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert g.shape == w.shape and got.dtype == torch.bfloat16
    bad = np.abs(g - w) > MODEL_TOL["atol"] + MODEL_TOL["rtol"] * np.abs(w)
    flips = bad & _bf16_neighbours(got, want)
    assert flips.sum() <= 1e-3 * g.size
    assert not (bad & ~flips).any()


@pytest.mark.parametrize("s", [24, 32, 40])
def test_prefill_cache_length(s):
    """cache_len 32: a shorter prompt pads the cache with zeros, an equal
    one fills it, a longer one keeps all its positions (length s)."""
    cfg, cfg_j = _cfgs("starcoder2_15b", num_layers=2)
    p = _f32_params(cfg_j)
    model = convert.from_jax(jax.tree.map(np.asarray, p), cfg, device="cpu")
    tok = np.random.default_rng(s).integers(0, cfg.vocab_size, (2, s), dtype=np.int32)
    jl, jc = JT.prefill(p, jnp.asarray(tok), cfg_j, JSINGLE, 32)
    logits, cache = T.prefill(model, torch.from_numpy(tok), cfg, SINGLE, 32)
    _close(logits, jl, MODEL_TOL)
    for k in ("k", "v"):
        assert cache[k].shape == (2, 2, max(s, 32), cfg.num_kv_heads, cfg.head_dim)
        _close_bf16_cache(cache[k], jc[k])
        assert not cache[k][:, :, s:].any()


@pytest.fixture(scope="module")
def pixtral():
    cfg, cfg_j = _cfgs("pixtral_12b", num_layers=2)
    p = _f32_params(cfg_j)
    model = convert.from_jax(jax.tree.map(np.asarray, p), cfg, device="cpu", trainable=True)
    rng = np.random.default_rng(11)
    tok = rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
    pe = rng.standard_normal((2, cfg.num_stub_tokens, cfg.d_model)).astype(np.float32)
    return cfg, cfg_j, p, model, tok, pe


def test_vlm_prefix_prefill(pixtral):
    """The patch embeddings run before the tokens, positions over both."""
    cfg, cfg_j, p, model, tok, pe = pixtral
    jl, jc = JT.prefill(p, jnp.asarray(tok), cfg_j, JSINGLE, 32, prefix_embed=jnp.asarray(pe))
    logits, cache = T.prefill(model, torch.from_numpy(tok), cfg, SINGLE, 32,
                              prefix_embed=torch.from_numpy(pe))
    _close(logits, jl, MODEL_TOL)
    assert cache["k"].shape[2] == 32
    for k in ("k", "v"):
        _close_bf16_cache(cache[k], jc[k])
    plain, _ = T.prefill(model, torch.from_numpy(tok), cfg, SINGLE, 32)
    assert not torch.allclose(plain, logits)


def test_vlm_prefix_loss_drops_the_prefix_positions(pixtral):
    cfg, cfg_j, p, model, tok, pe = pixtral
    labels = np.roll(tok, -1, axis=1)
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels),
              "patch_embed": jnp.asarray(pe)}
    want, jgrads = jax.jit(jax.value_and_grad(lambda q: JT.lm_loss(q, jbatch, cfg_j, JSINGLE)))(p)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(labels),
             "patch_embed": torch.from_numpy(pe)}
    loss = T.lm_loss(model, batch, cfg, SINGLE)
    _close(loss, want, MODEL_TOL)
    (g,) = torch.autograd.grad(loss, [model.embed])
    ref = np.asarray(jgrads["embed"])
    assert np.abs(g.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize("arch,tied", [("command_r_35b", True), ("qwen2_72b", False)])
def test_tied_and_untied_heads(arch, tied):
    cfg, cfg_j = _cfgs(arch, num_layers=1)
    assert cfg.tie_embeddings is tied
    p = _f32_params(cfg_j)
    model = convert.from_jax(jax.tree.map(np.asarray, p), cfg, device="cpu", trainable=True)
    w = T.unembed_weight(model, cfg)
    assert (w is model.embed) if tied else (w is model.head)
    assert tuple(w.shape) == JT.unembed_weight(p, cfg_j).shape
    assert hasattr(model, "head") is (not tied)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    want = jax.jit(lambda q, b: JT.lm_loss(q, b, cfg_j, JSINGLE))(
        p, {k: jnp.asarray(v) for k, v in batch.items()})
    _close(T.lm_loss(model, batch, cfg, SINGLE), want, MODEL_TOL)
    x = _randn(4, 2, 3, cfg.d_model)
    _close(L.unembed(torch.from_numpy(x), w, cfg.vocab_size),
           JL.unembed(jnp.asarray(x), JT.unembed_weight(p, cfg_j), JSINGLE, cfg.vocab_size),
           MODEL_TOL)


def test_xent_loss():
    logits = _randn(5, 2, 6, 50) * 3
    labels = np.random.default_rng(6).integers(0, 50, (2, 6), dtype=np.int32)
    _close(L.xent_loss(torch.from_numpy(logits), torch.from_numpy(labels), SINGLE),
           JL.xent_loss(jnp.asarray(logits), jnp.asarray(labels), JSINGLE))


# -- two-level remat ----------------------------------------------------------


def _toy_layers(n: int):
    w = _randn(12, n, 6, 6) * 0.5
    layers = torch.nn.ModuleList(torch.nn.ParameterDict(
        {"w": torch.nn.Parameter(torch.from_numpy(w[i].copy()))}) for i in range(n))
    return w, layers


def _toy_body(h, p):
    return torch.tanh(h @ p["w"]) + h


@pytest.mark.parametrize("block", [2, 3])
def test_scan_layers_block_gradients_equal_per_layer(block):
    """Blocks of ``block`` over 6 layers: the same output and gradients
    as the per-layer remat and as no remat, bit for bit; and the
    reference's ``scan_layers(block=...)`` gradients within TOL."""
    w, layers = _toy_layers(6)
    x = _randn(13, 4, 6)
    def no_remat(h, layers):
        for layer in layers:
            h = _toy_body(h, layer)
        return h

    out = {}
    cases = {"block": lambda h, ls: stack.scan_layers(_toy_body, h, ls, block=block),
             "per_layer": lambda h, ls: stack.scan_layers(_toy_body, h, ls),
             "none": no_remat}
    for name, fold in cases.items():
        xt = torch.from_numpy(x).requires_grad_(True)
        y = fold(xt, layers)
        grads = torch.autograd.grad(y.square().sum(), [xt, *layers.parameters()])
        out[name] = (y.detach(), grads)
    for name in ("per_layer", "none"):
        assert torch.equal(out["block"][0], out[name][0])
        assert all(torch.equal(a, b) for a, b in zip(out["block"][1], out[name][1]))

    def jbody(h, p):
        return jnp.tanh(h @ p["w"]) + h

    def jloss(x, w):
        return jnp.sum(jstack.scan_layers(jbody, x, {"w": w}, block=block) ** 2)

    jy = jstack.scan_layers(jbody, jnp.asarray(x), {"w": jnp.asarray(w)}, block=block)
    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    _close(out["block"][0], jy)
    _close(out["block"][1][0], jgx)
    _close(torch.stack(list(out["block"][1][1:])), jgw)


def test_scan_layers_block_that_does_not_divide_is_per_layer():
    """As in the reference: block 4 over 6 layers (or over <= 4) takes the
    per-layer path."""
    w, layers = _toy_layers(6)
    x = torch.from_numpy(_randn(14, 4, 6))
    assert torch.equal(stack.scan_layers(_toy_body, x, layers, block=4),
                       stack.scan_layers(_toy_body, x, layers))


# -- weights across the packages ----------------------------------------------


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_from_jax_then_to_reference_tree_is_bit_exact(arch):
    """bf16 weights and f32 norms and biases, every leaf bit for bit both
    ways; the port's own seeded init has the reference's tree (paths,
    shapes, dtypes) and its deterministic leaves (norms, zero biases)."""
    cfg, cfg_j = _cfgs(arch)
    p = JT.init_lm(cfg_j, jax.random.PRNGKey(1))
    model = convert.from_jax(jax.tree.map(np.asarray, p), cfg, device="cpu")
    back = convert.to_reference_tree(model)
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    assert len(flat) == len(jax.tree.leaves(back))
    own = convert.stacked_tree(T.init_lm(cfg, 0, device="cpu"))
    for path, leaf in flat:
        keys = [k.key for k in path]
        got, mine = back, own
        for k in keys:
            got, mine = got[k], mine[k]
        assert str(got.dtype).removeprefix("torch.") == str(leaf.dtype), keys
        assert tuple(got.shape) == leaf.shape == tuple(mine.shape), keys
        assert mine.dtype == got.dtype, keys
        ref = np.asarray(leaf)
        if ref.dtype.name == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), ref.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), ref)
        if keys[-1] in ("scale", "bias", "b"):
            np.testing.assert_array_equal(mine.numpy(), ref)
