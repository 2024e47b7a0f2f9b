"""The port's AdamW (``repro_torch.train.optimizer``) against the JAX
package's (``repro.train.optimizer``), on the stacked trees of the
reduced falcon-mamba (2 layers): the schedule, the int8 blockwise
quantizer, ``init_opt_state``, ``global_norm`` and three ``adamw_update``
steps from identical random trees and gradients, with and without
``quantize_v``; and the train step's donated ``adamw_update_`` against
the pure ``adamw_update``, bit for bit.

Tolerances, set from float32: the schedule within rtol 1e-6; after
each update, every element of the params, m and v within 1e-6 of its
leaf's max |ref| (the two frameworks reduce the global norm in another
order and round ``b ** count`` on their own, so values that cancel to
near zero differ in the last bit of their inputs' scale). The int8
``q`` and scales of the quantized v are equal, with the reference run
op by op inside the clip norm (see the test for why). The step count
and the set of leaves that take weight decay must be equal.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.models.convert import tree_to  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

CFG_J = jax_get_config("falcon_mamba_7b").reduced(num_layers=2)
REL = 1e-6
CONFIGS = {
    "default": dict(),
    "short": dict(lr=1e-3, warmup_steps=2, decay_steps=10),
    "no-warmup": dict(lr=2e-3, warmup_steps=0, decay_steps=0, min_lr_frac=0.0),
}


def _configs(**kw):
    return jopt.OptConfig(**kw), topt.OptConfig(**kw)


@pytest.fixture(scope="module")
def shapes():
    """The reduced falcon-mamba's stacked parameter tree as shapes."""
    tree = jax.eval_shape(lambda: jmamba.init_lm(CFG_J, jax.random.PRNGKey(0)))
    return jax.tree.map(lambda s: s.shape, tree)


def _draw(shapes, rng, scale):
    return jax.tree.map(lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
                        shapes, is_leaf=lambda s: isinstance(s, tuple))


def _pairs(ref_tree, port_tree):
    """(path, ref numpy, port numpy) over the reference's leaves; a
    quantized v leaf is the tuple (q, scale) on both sides."""
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_tree)
    out = []
    for path, ref in flat:
        node = port_tree
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        node = node.numpy() if isinstance(node, torch.Tensor) else np.asarray(node)
        out.append((jax.tree_util.keystr(path), np.asarray(ref), node))
    return out


def _close(ref_tree, port_tree):
    for path, ref, port in _pairs(ref_tree, port_tree):
        assert ref.dtype == port.dtype and ref.shape == port.shape, path
        if ref.dtype == np.int8:
            np.testing.assert_array_equal(port, ref, err_msg=path)
        else:
            err = np.max(np.abs(port - ref)) if ref.size else 0.0
            assert err <= REL * np.max(np.abs(ref)), (path, err)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_schedule_over_steps(name):
    jc, tc = _configs(**CONFIGS[name])
    steps = np.arange(0, 12_000, 7, dtype=np.int32)
    ref = np.asarray(jax.jit(lambda s: jopt.schedule(jc, s))(jnp.asarray(steps)))
    port = topt.schedule(tc, torch.from_numpy(steps)).numpy()
    assert port.dtype == np.float32
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(256,), (2, 128), (2, 256, 8), (1000,), (3, 7, 5)])
@pytest.mark.parametrize("block", [256, 64])
def test_quantize_and_dequantize(shape, block):
    """Blocks cut the flattened leaf (a (2, 128) leaf is one block of
    256 spanning both layers); q, scale and the round trip are equal."""
    rng = np.random.default_rng(sum(shape) + block)
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 2)).astype(np.float32)
    x.reshape(-1)[0] = 0.5 * np.abs(x).max()  # a value on a .5 step of its block's grid
    qj, sj = jopt._quantize(jnp.asarray(x), block)
    qt, st = topt._quantize(torch.from_numpy(x), block)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(topt._dequantize(qt, st, shape, block).numpy(),
                                  np.asarray(jopt._dequantize(qj, sj, shape, block)))


@pytest.mark.parametrize("quantize_v", [False, True])
def test_init_opt_state(shapes, quantize_v):
    jc, tc = _configs(quantize_v=quantize_v)
    params = _draw(shapes, np.random.default_rng(0), 1.0)
    ref = jopt.init_opt_state(jax.tree.map(jnp.asarray, params), jc)
    port = topt.init_opt_state(tree_to(params, "cpu"), tc)
    assert int(port["count"]) == 0 and port["count"].dtype == torch.int32
    _close(ref, port)


def test_global_norm(shapes):
    tree = _draw(shapes, np.random.default_rng(1), 0.3)
    ref = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    port = float(topt.global_norm(tree_to(tree, "cpu")))
    assert port == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("regime,quantize_v", [("eager", False), ("eager", True),
                                               ("jit-clipped", False)])
def test_adamw_update_matches_reference(shapes, regime, quantize_v):
    """Three steps from identical random trees.

    ``eager``: the reference op by op (no XLA fusion, so a division stays
    a division) with every gradient inside the clip norm: the clip scale
    is exactly 1 on both sides, the elementwise arithmetic is the same,
    and the quantized v (q and scales) is equal bit for bit.

    ``jit-clipped``: the reference jitted, as its train step runs it,
    and the first gradient clipped (norm ~53). The global norm is a sum
    reduced in another order, so the clip scale differs in its last bit
    and every leaf stays within the tolerance above. The quantized v has
    no such case: a last-bit difference can move v / scale across a .5
    rounding boundary, and one int8 step of v is 1/127 of its block's
    largest value, which no float tolerance of v or the params absorbs."""
    jc, tc = _configs(lr=1e-3, warmup_steps=2, decay_steps=10, quantize_v=quantize_v)
    rng = np.random.default_rng(2)
    params = _draw(shapes, rng, 1.0)
    ref_p = jax.tree.map(jnp.asarray, params)
    ref_s = jopt.init_opt_state(ref_p, jc)
    port_p = tree_to(params, "cpu")
    port_s = topt.init_opt_state(port_p, tc)
    clipped = regime == "jit-clipped"
    update = lambda g, s, p: jopt.adamw_update(g, s, p, jc)  # noqa: E731
    update = jax.jit(update) if clipped else update
    for i in range(3):
        grads = _draw(shapes, rng, 0.1 if clipped and i == 0 else 1e-3)
        ref_p, ref_s, ref_m = update(jax.tree.map(jnp.asarray, grads), ref_s, ref_p)
        port_p, port_s, port_m = topt.adamw_update(tree_to(grads, "cpu"), port_s, port_p, tc)
        assert (float(ref_m["grad_norm"]) > jc.clip_norm) == (clipped and i == 0)
        assert float(port_m["grad_norm"]) == pytest.approx(float(ref_m["grad_norm"]), rel=1e-6)
        assert float(port_m["lr"]) == pytest.approx(float(ref_m["lr"]), rel=1e-6)
        assert int(port_s["count"]) == int(ref_s["count"]) == i + 1
        _close(ref_p, port_p)
        _close(ref_s["m"], port_s["m"])
        if quantize_v:
            for path, ref, port in _pairs(ref_s["v"], port_s["v"]):
                np.testing.assert_array_equal(port, ref, err_msg=path)
        else:
            _close(ref_s["v"], port_s["v"])
    if quantize_v:
        assert all(isinstance(v, tuple) for v in topt.tree_leaves(port_s["v"]))


def test_decay_set_is_the_references(shapes):
    """With zero gradients the update is the weight decay alone: the
    leaves it moves are the stacked ones of rank >= 2 on both sides,
    which takes in every per-layer vector and leaves out ``ln_f``."""
    jc, tc = _configs(lr=1e-2, warmup_steps=0)
    params = _draw(shapes, np.random.default_rng(3), 1.0)
    zeros = jax.tree.map(np.zeros_like, params)
    ref_p, _, _ = jopt.adamw_update(jax.tree.map(jnp.asarray, zeros),
                                    jopt.init_opt_state(jax.tree.map(jnp.asarray, params), jc),
                                    jax.tree.map(jnp.asarray, params), jc)
    port_in = tree_to(params, "cpu")
    port_p, _, _ = topt.adamw_update(tree_to(zeros, "cpu"), topt.init_opt_state(port_in, tc),
                                     port_in, tc)
    moved = {}
    for side, tree in (("ref", ref_p), ("port", port_p)):
        moved[side] = {path for path, old, new in _pairs(params, tree)
                       if not np.array_equal(new, old)}
    by_rank = {path for path, old, _ in _pairs(params, port_in) if old.ndim >= 2}
    assert moved["ref"] == moved["port"] == by_rank
    assert "['ln_f']['scale']" not in by_rank and "['layers']['d_skip']" in by_rank


@pytest.mark.parametrize("chunk", [1 << 24, 300, 256])
@pytest.mark.parametrize("quantize_v", [False, True])
def test_donated_update_equals_the_pure_one(shapes, quantize_v, chunk, monkeypatch):
    """``adamw_update_`` (the train step's: params, m and v overwritten
    in place, ``CHUNK`` elements at a time, rounded to whole ``qblock``
    blocks) against ``adamw_update`` over three steps, the first
    gradient clipped: every leaf equal bit for bit, and the state's
    tensors are the ones passed in."""
    monkeypatch.setattr(topt, "CHUNK", chunk)
    tc = topt.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=10, quantize_v=quantize_v)
    rng = np.random.default_rng(4)
    params = _draw(shapes, rng, 1.0)
    pure_p, pure_s = tree_to(params, "cpu"), topt.init_opt_state(tree_to(params, "cpu"), tc)
    own_p, own_s = tree_to(params, "cpu"), topt.init_opt_state(tree_to(params, "cpu"), tc)
    m_leaves = topt.tree_leaves(own_s["m"])
    for i in range(3):
        grads = _draw(shapes, rng, 0.1 if i == 0 else 1e-3)
        pure_p, pure_s, pure_m = topt.adamw_update(tree_to(grads, "cpu"), pure_s, pure_p, tc)
        own_s, own_m = topt.adamw_update_(tree_to(grads, "cpu"), own_s, own_p, tc)
        assert float(own_m["grad_norm"]) == float(pure_m["grad_norm"])
        assert int(own_s["count"]) == int(pure_s["count"]) == i + 1
        for a, b in zip(topt.tree_leaves(own_p), topt.tree_leaves(pure_p), strict=True):
            assert torch.equal(a, b)
        for name in ("m", "v"):
            for a, b in zip(topt.tree_leaves(own_s[name]), topt.tree_leaves(pure_s[name]),
                            strict=True):
                pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
                assert all(torch.equal(x, y) for x, y in pairs), name
    assert all(a is b for a, b in zip(topt.tree_leaves(own_s["m"]), m_leaves))
