"""The port's ssm family (falcon-mamba) against the JAX package's.

``reduced()`` falcon-mamba (4 layers, d_model 128, N 8, scan_chunk 16)
with the JAX package's ``init_lm`` weights carried across by
``models/convert.py``. ``prefill`` logits and stacked cache, and one
``decode_step`` from that cache, at prompt lengths 64 (four chunks of
16, so the chunk carry is exercised) and 40 (``fit_chunk`` picks 10).

- float32 (the parameters cast in both packages): rtol = atol = 1e-4.
  Only the order of f32 sums differs (matmuls, the scan's sum over n).
- bfloat16 (the reference's own dtypes): max |port - ref| <= 2e-2 *
  max |ref| for every compared tensor. The two frameworks round bf16 at
  other places (XLA fuses the elementwise chains and rounds once; torch
  rounds after each op), and 4 layers of bf16 residual stream compound
  it; the largest measured here is 1.55e-2 (decode logits, S = 40). The
  float32 case, where the largest is 1.1e-6 of max |ref|, holds the
  algorithm.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models.shardings import SINGLE as JSINGLE  # noqa: E402
from repro.models.shardings import ServePlan as JServePlan  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.models.shardings import SINGLE  # noqa: E402

CFG_J = jax_get_config("falcon_mamba_7b").reduced()
CFG = get_config("falcon_mamba_7b").reduced()
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL = 2e-2
LENGTHS = (64, 40)
DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    return jmamba.init_lm(CFG_J, jax.random.PRNGKey(0))


def _cast(params, dtype):
    if dtype == "bfloat16":
        return params
    return jax.tree.map(lambda a: a.astype(jnp.float32), params)


@pytest.fixture(scope="module")
def runs(jax_params):
    """(dtype, S) -> {name: (port array, ref array)} for prefill and one
    decode step, B = 2."""
    jprefill = jax.jit(lambda p, t: jmamba.prefill(p, t, CFG_J, JSINGLE, 0))
    jdecode = jax.jit(lambda p, t, c: jmamba.decode_step(p, t, c, 0, CFG_J, JSINGLE,
                                                         JServePlan()))
    out = {}
    for dtype in DTYPES:
        jp = _cast(jax_params, dtype)
        model = from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu",
                         dtype=torch.float32 if dtype == "float32" else None)
        for s in LENGTHS:
            tokens = np.random.default_rng(s).integers(0, CFG.vocab_size, (2, s), dtype=np.int32)
            jlogits, jstate = jprefill(jp, jnp.asarray(tokens))
            logits, state = mamba.prefill(model, torch.from_numpy(tokens), CFG, SINGLE, 0)
            nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]
            jlogits2, jcache2 = jdecode(jp, jnp.asarray(nxt), jstate)
            logits2, cache2 = mamba.decode_step(model, torch.from_numpy(nxt), state, 0, CFG)
            pairs = {
                "prefill_logits": (logits, jlogits),
                "prefill_conv": (state["conv"], jstate["conv"]),
                "prefill_ssm": (state["ssm"], jstate["ssm"]),
                "decode_logits": (logits2, jlogits2),
                "decode_conv": (cache2["conv"], jcache2["conv"]),
                "decode_ssm": (cache2["ssm"], jcache2["ssm"]),
            }
            out[dtype, s] = {
                k: (p.float().numpy(), np.asarray(r, np.float32), str(p.dtype), str(r.dtype))
                for k, (p, r) in pairs.items()
            }
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("what", ["logits", "conv", "ssm"])
@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_matches_jax(step, what, s, dtype, runs):
    got, want, got_dtype, want_dtype = runs[dtype, s][f"{step}_{what}"]
    assert got.shape == want.shape
    assert got_dtype.removeprefix("torch.") == want_dtype
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


def test_reduced_config_is_the_references():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(CFG_J)
    assert CFG.d_inner == CFG_J.d_inner


def test_convert_is_exact(jax_params):
    """Every leaf, bf16 ones included, arrives bit for bit."""
    model = from_jax(jax.tree.map(np.asarray, jax_params), CFG, device="cpu")
    sd = model.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    assert len(sd) == (len(flat) - 2) * CFG.num_layers + 2
    for path, leaf in flat:
        key = ".".join(str(getattr(k, "key", k)) for k in path)
        leaf = np.asarray(leaf, np.float32)
        if key.startswith("layers."):
            for i in range(CFG.num_layers):
                np.testing.assert_array_equal(
                    sd[key.replace("layers.", f"layers.{i}.", 1)].float().numpy(), leaf[i])
        else:
            np.testing.assert_array_equal(sd[key].float().numpy(), leaf)


def test_init_shapes_and_dtypes_match(jax_params):
    """The port's own seeded init has the reference's tree: shapes,
    dtypes and the deterministic leaves (a_log, d_skip, conv_b, norms)."""
    model = mamba.init_lm(CFG, 0, device="cpu")
    sd = model.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_params)[0]:
        key = ".".join(str(getattr(k, "key", k)) for k in path)
        if key.startswith("layers."):
            got = sd[key.replace("layers.", "layers.0.", 1)]
            leaf = leaf[0]
        else:
            got = sd[key]
        assert tuple(got.shape) == leaf.shape, key
        assert str(got.dtype).removeprefix("torch.") == str(leaf.dtype), key
        if key.split(".")[-1] in ("a_log", "d_skip", "conv_b", "scale"):
            np.testing.assert_allclose(got.numpy(), np.asarray(leaf), rtol=1e-6)
    b = sd["layers.0.dt_proj.b"]
    dt = torch.nn.functional.softplus(b)
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 1e-1 * 1.001


@pytest.mark.parametrize("batch", [1, 4])
def test_cache_shape_matches(batch):
    want = jmamba.cache_shape(CFG_J, batch, 128)
    got = mamba.cache_shape(CFG, batch, 128)
    cache = mamba.init_cache(CFG, batch, 128, device="cpu")
    for k in ("conv", "ssm"):
        assert got[k].shape == want[k].shape
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
        assert cache[k].shape == got[k].shape and not cache[k].any()


@pytest.mark.parametrize("s", [1, 5, 40, 64, 128])
def test_fit_chunk(s):
    from repro.models.layers import fit_chunk as jfit
    from repro_torch.models.layers import fit_chunk

    assert fit_chunk(s, CFG.scan_chunk) == jfit(s, CFG_J.scan_chunk)


def test_layer_loops_match_the_references_scans():
    """``stack.scan_layers`` / ``scan_layers_with_cache`` against the
    reference's ``lax.scan`` traversals on a toy body."""
    from repro.models import stack as jstack
    from repro_torch.models import stack

    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    x = rng.standard_normal((2, 5)).astype(np.float32)
    c = rng.standard_normal((3, 2, 5)).astype(np.float32)
    layers = torch.nn.ModuleList(torch.nn.ParameterDict({"w": torch.nn.Parameter(
        torch.from_numpy(w[i]), requires_grad=False)}) for i in range(3))
    want = jstack.scan_layers(lambda h, p: jnp.tanh(h * p["w"] + 1), jnp.asarray(x),
                              {"w": jnp.asarray(w)})
    got = stack.scan_layers(lambda h, p: torch.tanh(h * p["w"] + 1), torch.from_numpy(x),
                            layers)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    want_x, want_c = jstack.scan_layers_with_cache(
        lambda h, p, lc: (h + lc["c"] * p["w"], {"c": lc["c"] - h}), jnp.asarray(x),
        {"w": jnp.asarray(w)}, {"c": jnp.asarray(c)})
    got_x, got_c = stack.scan_layers_with_cache(
        lambda h, p, lc: (h + lc["c"] * p["w"], {"c": lc["c"] - h}), torch.from_numpy(x),
        layers, {"c": torch.from_numpy(c)})
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **F32_TOL)
    np.testing.assert_allclose(got_c["c"].numpy(), np.asarray(want_c["c"]), **F32_TOL)
