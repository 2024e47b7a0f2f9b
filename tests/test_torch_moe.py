"""The port's moe FFN (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, function by function, from the same
numpy inputs: olmoe-1b-7b and granite-moe-3b-a800m at ``reduced()`` (d
128, 8 experts, top 2, expert d_ff 256), batch 2 x 64 tokens.
Tolerances, set from the dtypes before the runs:

- ``top_k`` and ``route``: the expert indices bit for bit, with ties
  planted (integer-valued inputs, whose products are exact in float32
  and bfloat16, and a router whose experts share columns in threes, so
  that the top k of most tokens tie); gates and the aux loss within
  1e-6;
- ``capacity``: equal over a grid of sequence lengths;
- ``moe_ffn`` in float32: rtol = atol = 1e-5, at a capacity factor low
  enough that choices are dropped (asserted) and at one high enough that
  none is (asserted); the aux loss within 1e-6;
- ``moe_ffn``'s gradients with respect to x and every weight, float32:
  within 1e-4 of each leaf's max |ref|;
- bfloat16 from the same bf16 inputs: the indices bit for bit and the
  output within 2e-2 of max |ref| (the frameworks round the expert
  products at other places).

The moe model tree crosses ``models.convert`` both ways bit for bit.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.models.moe as jmoe  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro.models.shardings import SINGLE as JSINGLE  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import convert, moe  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

ARCHS = ("olmoe_1b_7b", "granite_moe_3b_a800m")
B, S = 2, 64
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str, **kw):
    return (get_config(arch).reduced(**kw), jax_get_config(arch).reduced(**kw))


def _params(cfg, cfg_j, dtype: str, seed: int = 0):
    """The reference's ``init_moe`` in ``dtype`` (router f32), and the
    port's ``Moe`` holding the same values."""
    p = jmoe.init_moe(jax.random.PRNGKey(seed), cfg_j, DTYPES[dtype][1])
    host = jax.tree.map(np.asarray, p)
    m = moe.init_moe(None, cfg, DTYPES[dtype][0], "cpu")
    m.load_state_dict({"router.w": convert.to_tensor(host["router"]["w"], "cpu"),
                       **{k: convert.to_tensor(host[k], "cpu") for k in ("wg", "wu", "wd")}},
                      strict=True, assign=True)
    return p, m


def _x(cfg, dtype: str, seed: int = 0, *, integers: bool = False):
    rng = np.random.default_rng(seed)
    if integers:
        x = rng.integers(-2, 3, (B, S, cfg.d_model)).astype(np.float32)
    else:
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(x).to(DTYPES[dtype][0]), jnp.asarray(x, DTYPES[dtype][1])


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# -- top_k and route ----------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_top_k_breaks_ties_as_lax_top_k(dtype, k):
    rng = np.random.default_rng(k)
    x = rng.integers(0, 4, (32, 16)).astype(np.float32)  # many ties
    x[0, :5] = [1, 3, 3, 2, 3]
    vals, idx = moe.top_k(torch.from_numpy(x).to(DTYPES[dtype][0]), k)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x, DTYPES[dtype][1]), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(_np(vals), _np(jvals))
    if k >= 2:
        assert idx[0, :2].tolist() == [1, 2]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("planted", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch, planted, dtype):
    cfg, cfg_j = _cfgs(arch)
    p, m = _params(cfg, cfg_j, dtype)
    if planted:  # integer inputs, experts in threes of one router column: exact ties
        base = np.random.default_rng(1).integers(-1, 2, (cfg.d_model, cfg.num_experts))
        w = base[:, np.arange(cfg.num_experts) // 3].astype(np.float32)
        p = {**p, "router": {"w": jnp.asarray(w)}}
        m.router.w.data = torch.from_numpy(w)
    x, jx = _x(cfg, dtype, integers=planted)
    gates, idx, aux = moe.route(x, m.router.w, cfg)
    jgates, jidx, jaux = jmoe.route(jx, p["router"]["w"], cfg_j)
    logits = moe.L.einsum_f32("bsd,de->bse", x, m.router.w.to(x.dtype))
    if planted:
        kth = torch.sort(logits, -1, descending=True).values[..., cfg.experts_per_token - 1:
                                                             cfg.experts_per_token + 1]
        assert int((kth[..., 0] == kth[..., 1]).sum()) > B * S // 4  # ties at the cut
    assert idx.dtype == torch.int64 and gates.dtype == aux.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", [*ARCHS, "olmoe_full", "granite_full"])
def test_capacity_matches_reference(arch):
    if arch.endswith("_full"):
        name = ARCHS[0] if arch == "olmoe_full" else ARCHS[1]
        cfgs = [(get_config(name), jax_get_config(name))]
    else:
        cfgs = [_cfgs(arch, capacity_factor=cf) for cf in (0.25, 1.0, 1.25, 2.0)]
    for cfg, cfg_j in cfgs:
        for s in (1, 2, 3, 7, 8, 31, 64, 100, 2048, 4096, 32768):
            assert moe.capacity(cfg, s) == jmoe.capacity(cfg_j, s), (cfg.capacity_factor, s)
    if arch == "olmoe_full":
        assert moe.capacity(cfgs[0][0], 32768) == 5120 and moe.capacity(cfgs[0][0], 1) == 8


# -- moe_ffn ------------------------------------------------------------------


def _dropped(idx: torch.Tensor, cfg, s: int) -> int:
    """Choices beyond their expert's capacity, summed over the batch."""
    cap = moe.capacity(cfg, s)
    counts = torch.stack([torch.bincount(row.reshape(-1), minlength=cfg.num_experts)
                          for row in idx])
    return int((counts - cap).clamp(min=0).sum())


@pytest.mark.parametrize("drops", [True, False], ids=["drops", "no-drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, drops):
    # 0.25 leaves 8 slots an expert for 32 choices on average; E / k
    # gives every expert a slot for every token
    cf = 0.25 if drops else get_config(arch).reduced().num_experts / 2
    cfg, cfg_j = _cfgs(arch, capacity_factor=cf)
    p, m = _params(cfg, cfg_j, "float32")
    x, jx = _x(cfg, "float32")
    y, aux = moe.moe_ffn(x, m, cfg)
    jy, jaux = jmoe.moe_ffn(jx, p, cfg_j, JSINGLE)
    dropped = _dropped(moe.route(x, m.router.w, cfg)[1], cfg, S)
    assert (dropped > 0) if drops else (dropped == 0), dropped
    assert y.shape == (B, S, cfg.d_model) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(moe.moe_ffn_noaux(x, m, cfg).numpy(), y.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_gradients_match_reference(arch):
    """d/d(x, router, wg, wu, wd) of sum(y * r) + aux, with drops."""
    cfg, cfg_j = _cfgs(arch, capacity_factor=0.5)
    p, m = _params(cfg, cfg_j, "float32")
    x, jx = _x(cfg, "float32")
    r = np.random.default_rng(2).standard_normal((B, S, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(x, p, cfg_j, JSINGLE)
        return jnp.sum(y * r) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, jx)
    x.requires_grad_(True)
    m.requires_grad_(True)
    y, aux = moe.moe_ffn(x, m, cfg)
    leaves = [x, m.router.w, m.wg, m.wu, m.wd]
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(r)) + aux, leaves)
    want = [jgx, jgp["router"]["w"], jgp["wg"], jgp["wu"], jgp["wd"]]
    assert _dropped(moe.route(x, m.router.w, cfg)[1], cfg, S) > 0
    for name, g, w in zip(("x", "router", "wg", "wu", "wd"), grads, want, strict=True):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_bf16_from_the_same_inputs(arch):
    cfg, cfg_j = _cfgs(arch)
    p, m = _params(cfg, cfg_j, "bfloat16")
    x, jx = _x(cfg, "bfloat16")
    y, _ = moe.moe_ffn(x, m, cfg)
    jy, _ = jax.jit(lambda p, x: jmoe.moe_ffn(x, p, cfg_j, JSINGLE))(p, jx)
    np.testing.assert_array_equal(moe.route(x, m.router.w, cfg)[1].numpy(),
                                  np.asarray(jmoe.route(jx, p["router"]["w"], cfg_j)[1]))
    assert y.dtype == torch.bfloat16
    assert np.abs(_np(y) - _np(jy)).max() <= 2e-2 * np.abs(_np(jy)).max()


# -- the model tree -----------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_tree_converts_bit_for_bit(arch):
    """The reference's ``init`` tree -> the port's model -> the reference's
    layout: every leaf's dtype, shape and bytes equal; the router f32,
    the expert weights bf16; a tied head leaves no ``head``."""
    cfg, cfg_j = _cfgs(arch)
    tree = jax.tree.map(np.asarray, jax_get_model(cfg_j).init(cfg_j, jax.random.PRNGKey(0)))
    model = convert.from_jax(tree, cfg, device="cpu")
    assert ("head" in tree) == (not cfg.tie_embeddings) == hasattr(model, "head")
    assert model.layers[0].ffn.router.w.dtype == torch.float32
    assert model.layers[0].ffn.wg.dtype == torch.bfloat16
    back = convert.to_reference_tree(model)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(jax.tree.leaves(back))
    for path, ref in flat:
        got = back
        for k in path:
            got = got[k.key]
        assert str(got.dtype).removeprefix("torch.") == str(ref.dtype), path
        assert tuple(got.shape) == ref.shape, path
        assert got.contiguous().view(torch.uint8).numpy().tobytes() == ref.tobytes(), path
    own = get_model(cfg).init(cfg, 0, device="cpu")
    assert [(n, p.shape, p.dtype) for n, p in own.named_parameters()] == [
        (n, p.shape, p.dtype) for n, p in model.named_parameters()]


def test_moe_config_fields_are_the_references():
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert get_config("olmoe_1b_7b").num_experts == 64
