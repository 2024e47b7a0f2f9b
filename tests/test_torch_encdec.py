"""The encdec family's modules (``models/encdec.py``,
``layers.cross_attention``) against the JAX package's, one by one:
``sinusoid``, ``cross_attention``, ``apply_dec_layer``, ``encode`` (in
bf16, and in float32 where the reference's raises), ``prefill``'s padded
self-attention cache and its ``mem_k`` / ``mem_v``, ``decode_step``, the
port's own init and ``convert``.

Inputs come from seeded numpy generators and go to both packages; the
weights are the reference's ``init_lm`` for the reduced seamless-m4t
(2 + 2 layers, 8 encoder frames), carried across. Tolerances, set
before the runs: float32 modules within rtol = atol = 1e-4, bf16 within
2e-2 of max |ref| (tests/test_torch_models.py), bf16 cache leaves also
their one-ulp neighbours. In float32 the reference's encoder runs as
tests/torch_model_cases.py composes it (``unrolled_encode``, op by op):
its own ``encode`` raises ``TypeError`` there.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch_model_cases as C  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.shardings import SINGLE as JSINGLE  # noqa: E402
from repro.models.shardings import ServePlan as JServePlan  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, encdec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.shardings import SINGLE  # noqa: E402
from repro_torch.models.stack import tree_paths  # noqa: E402

ARCH = "seamless_m4t_large_v2"
F32 = dict(rtol=1e-4, atol=1e-4)
CFG = configs.get_config(ARCH).reduced()
CFG_J = jconfigs.get_config(ARCH).reduced()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    """{dtype: (reference tree, port model)}."""
    p = jencdec.init_lm(CFG_J, jax.random.PRNGKey(0))
    out = {}
    for dtype in ("bfloat16", "float32"):
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), p) if dtype == "float32" else p
        out[dtype] = jp, convert.from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    return out


def _src(seed=1, b=2):
    src = torch.from_numpy(_randn(seed, b, CFG.num_stub_tokens, CFG.d_model)).to(torch.bfloat16)
    return src, jnp.asarray(src.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("pos", [0, 1, 5, 63, 1000])
def test_sinusoid(pos):
    """Within two float32 ulps of the largest angle, pos * 2^-22 (the
    frameworks' ``exp`` of a frequency may differ by one ulp, which the
    angle carries), and 1e-7."""
    got = encdec.sinusoid(torch.tensor([pos]), 128).numpy()
    want = np.asarray(jencdec.sinusoid(jnp.asarray([pos]), 128))
    np.testing.assert_allclose(got, want, rtol=0, atol=pos * 2.0 ** -22 + 1e-7)


@pytest.mark.parametrize("s,t", [(1, 8), (5, 8), (16, 3)])
def test_cross_attention(params, s, t):
    """f32 queries over a precomputed (B, T, H, hd) memory: no mask, no
    chunks, the output projection."""
    jp, model = params["float32"]
    lp = jax.tree.map(lambda a: a[0], jp["dec"])["cross_attn"]
    x = _randn(2, 2, s, CFG.d_model)
    mk = _randn(3, 2, t, CFG.num_kv_heads, CFG.head_dim)
    mv = _randn(4, 2, t, CFG.num_kv_heads, CFG.head_dim)
    want = JL.cross_attention(jnp.asarray(x), jnp.asarray(mk), jnp.asarray(mv), lp, CFG_J,
                              JSINGLE)
    got = L.cross_attention(torch.from_numpy(x), torch.from_numpy(mk), torch.from_numpy(mv),
                            model.dec[0].cross_attn, CFG, SINGLE)
    assert got.shape == (2, s, CFG.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_apply_dec_layer(params):
    """One decoder layer over a given float32 memory: causal
    self-attention, cross-attention, the gelu MLP."""
    jp, model = params["float32"]
    lp = jax.tree.map(lambda a: a[1], jp["dec"])
    x, mem = _randn(5, 2, 24, CFG.d_model), _randn(6, 2, 8, CFG.d_model)
    want = jencdec.apply_dec_layer(jnp.asarray(x), lp, jnp.asarray(mem), CFG_J, JSINGLE)
    got = encdec.apply_dec_layer(torch.from_numpy(x), model.dec[1], torch.from_numpy(mem), CFG)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)


def test_encode_bf16(params):
    jp, model = params["bfloat16"]
    src, jsrc = _src()
    want = jax.jit(lambda p, s: jencdec.encode(p, s, CFG_J, JSINGLE))(jp, jsrc)
    got = encdec.encode(model, src, CFG)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    C.assert_bf16_close(got, want)


def test_encode_f32_runs_where_the_reference_raises(params):
    """With float32 weights the reference's encoder scan refuses its
    carry (bf16 in, float32 out: ``TypeError``); the port lets the
    residual promote, as the reference's layers do when applied one by
    one, and matches them at 1e-4."""
    jp, model = params["float32"]
    src, jsrc = _src()
    with pytest.raises(TypeError):
        jencdec.encode(jp, jsrc, CFG_J, JSINGLE)
    got = encdec.encode(model, src, CFG)
    assert got.dtype == torch.float32
    want = C.unrolled_encode(jp, jsrc, CFG_J, JSINGLE)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,cache_len", [(12, 32), (20, 16)])
def test_prefill_then_decode(params, dtype, s, cache_len):
    """``prefill``: logits, the self-attention k and v zero-padded to
    ``cache_len`` (or kept at s when that is longer), and each layer's
    cross-attention memory, all bf16; then two decode steps from that
    cache (cast to float32 for the float32 case). f32 at 1e-4, bf16
    within 2e-2 of max |ref|."""
    jp, model = params[dtype]
    src, jsrc = _src(7)
    tok = np.random.default_rng(8).integers(0, CFG.vocab_size, (2, s), dtype=np.int32)
    with C.reference(CFG_J, dtype) as run:
        jl, jc = run(lambda p, t, x: jencdec.prefill(p, t, CFG_J, JSINGLE, cache_len,
                                                     src_embed=x))(jp, jnp.asarray(tok), jsrc)
    pl, pc = encdec.prefill(model, torch.from_numpy(tok), CFG, SINGLE, cache_len,
                            src_embed=src)
    length = max(s, cache_len)
    assert pc["k"].shape == (CFG.dec_layers, 2, length, CFG.num_kv_heads, CFG.head_dim)
    assert pc["mem_k"].shape == (CFG.dec_layers, 2, CFG.num_stub_tokens, CFG.num_kv_heads,
                                 CFG.head_dim)
    assert all(v.dtype == torch.bfloat16 for v in pc.values())
    assert not pc["k"][:, :, s:].any() and not pc["v"][:, :, s:].any()
    steps = [((pl, pc), (jl, jc))]
    if dtype == "float32":
        jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
        pc = C.to_torch(jc)
    jdecode = jax.jit(lambda p, t, c, pos: jencdec.decode_step(p, t, c, pos, CFG_J, JSINGLE,
                                                                JServePlan()))
    for i in range(2 if s < length else 0):
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.asarray(s + i))
        pl, pc = encdec.decode_step(model, torch.from_numpy(nxt), pc, s + i, CFG, SINGLE, None)
        steps.append(((pl, pc), (jl, jc)))
    for (logits, cache), (jlogits, jcache) in steps:
        assert set(cache) == set(jcache) == {"k", "v", "mem_k", "mem_v"}
        pairs = [(logits, jlogits)] + [(cache[k], jcache[k]) for k in cache]
        for got, want in pairs:
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
            if dtype == "bfloat16":
                C.assert_bf16_close(got, want)
            else:
                C.assert_f32_close(got, want, bf16_leaf=got.dtype == torch.bfloat16)


def test_init_and_convert():
    """The port's seeded init has the reference's tree (paths, shapes,
    dtypes), its deterministic leaves (layernorm scales and biases, MLP
    biases), and ``from_jax`` / ``to_reference_tree`` are bit for bit."""
    jp = jencdec.init_lm(CFG_J, jax.random.PRNGKey(1))
    back = convert.to_reference_tree(convert.from_jax(jax.tree.map(np.asarray, jp), CFG,
                                                      device="cpu"))
    own = convert.stacked_tree(encdec.init_lm(CFG, 0, device="cpu"))
    ref, got, mine = tree_paths(jp), tree_paths(back), tree_paths(own)
    assert set(ref) == set(got) == set(mine)
    for name, leaf in ref.items():
        assert str(got[name].dtype).removeprefix("torch.") == str(leaf.dtype), name
        assert tuple(got[name].shape) == leaf.shape == tuple(mine[name].shape), name
        want = np.asarray(leaf)
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(got[name].view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got[name].numpy(), want)
        if name.rsplit(".", 1)[-1] in ("scale", "bias", "b"):
            np.testing.assert_array_equal(mine[name].numpy(), want)
    assert got["head"].shape == (CFG.d_model, CFG.vocab_size)
