"""The hybrid family's modules (``models/rglru.py``) against the JAX
package's, one by one: ``_gates``, ``rglru_scan`` (K8's route, here its
plain version, and the associative scan taken under grad), ``rglru_step``,
``rec_mix`` from a carried conv and LRU state, the whole reduced
recurrentgemma's ``prefill`` with a prompt longer than the window and
not a multiple of it (the ring roll), ``decode_step`` across the window
ring's wrap, the short-prompt cache, the port's own init and
``convert`` with the ``tail`` list.

Inputs come from seeded numpy generators and go to both packages; the
weights are the reference's ``init_rglru`` / ``init_rec_block`` /
``init_lm``, carried across. Tolerances, set before the runs: float32
modules within rtol = atol = 1e-5 (only the order of float32 sums
differs), the scans within the reference's own 2e-4
(tests/test_scan_oracles.py), whole models within 1e-4 with the bf16
window cache also allowed one-ulp neighbours (tests/test_torch_models.py);
bf16 modules within 2e-2 of max |ref|; weight conversion bit for bit.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch_model_cases as C  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.shardings import SINGLE as JSINGLE  # noqa: E402
from repro.models.shardings import ServePlan as JServePlan  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, rglru  # noqa: E402
from repro_torch.models.shardings import SINGLE  # noqa: E402
from repro_torch.models.stack import tree_paths  # noqa: E402

ARCH = "recurrentgemma_9b"
TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return configs.get_config(ARCH).reduced(**kw), jconfigs.get_config(ARCH).reduced(**kw)


def _module(module, tree):
    """``module`` holding the reference dict ``tree``'s values (bf16
    leaves too), bit for bit."""
    module.load_state_dict({k: convert.to_tensor(np.asarray(v), "cpu")
                            for k, v in tree_paths(tree).items()})
    return module


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def lru():
    cfg, cfg_j = _cfgs()
    jp = jrglru.init_rglru(jax.random.PRNGKey(3), cfg_j, dtype=jnp.float32)
    return cfg, cfg_j, jp, _module(rglru.RgLru(cfg, None, torch.float32, "cpu"), jp)


def test_gates(lru):
    cfg, cfg_j, jp, p = lru
    x = _randn(0, 2, 7, cfg.lru_width)
    jla, jg = jrglru._gates(jnp.asarray(x), jp, cfg_j)
    la, g = rglru._gates(torch.from_numpy(x), p, cfg)
    assert la.dtype == g.dtype == torch.float32
    np.testing.assert_allclose(la.numpy(), np.asarray(jla), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("s,chunk", [(1, 16), (7, 4), (33, 16), (64, 16)])
@pytest.mark.parametrize("route", ["k8", "grad"])
def test_rglru_scan(lru, s, chunk, route, monkeypatch):
    """From a carried h0: y and h_last at the reference's 2e-4, K8's
    route (its plain version on the CPU) launched once without grad and
    never under it."""
    cfg, cfg_j, jp, p = lru
    cfg = dataclasses.replace(cfg, scan_chunk=chunk)
    cfg_j = dataclasses.replace(cfg_j, scan_chunk=chunk)
    x, h0 = _randn(1, 2, s, cfg.lru_width), _randn(2, 2, cfg.lru_width)
    jy, jh = jrglru.rglru_scan(jnp.asarray(x), jp, cfg_j, jnp.asarray(h0))
    calls = []
    real = rglru.selective_scan
    monkeypatch.setattr(rglru, "selective_scan",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    tx = torch.from_numpy(x).requires_grad_(route == "grad")
    y, h = rglru.rglru_scan(tx, p, cfg, torch.from_numpy(h0))
    assert calls == ([] if route == "grad" else [(2, s, cfg.lru_width, 1)])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **SCAN_TOL)


def test_rglru_step(lru):
    cfg, cfg_j, jp, p = lru
    x, h0 = _randn(3, 2, 1, cfg.lru_width), _randn(4, 2, cfg.lru_width)
    jy, jh = jrglru.rglru_step(jnp.asarray(x), jp, cfg_j, jnp.asarray(h0))
    y, h = rglru.rglru_step(torch.from_numpy(x), p, cfg, torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 9])
def test_rec_mix_with_carried_state(s, dtype):
    """The recurrent mix from a carried conv window and LRU state (one
    token takes ``rglru_step``, a chunk the scan), in float32 at 1e-5 (2e-4
    for the scanned chunk) and in bf16 within 2e-2 of max |ref|."""
    cfg, cfg_j = _cfgs()
    dt = getattr(jnp, dtype)
    jp = jrglru.init_rec_block(jax.random.PRNGKey(5), cfg_j, dtype=dt)
    p = _module(rglru.RecBlock(cfg, None, getattr(torch, dtype), "cpu"), jp)
    x = _randn(6, 2, s, cfg.d_model)
    conv = _randn(7, 2, cfg.d_conv - 1, cfg.lru_width)
    h0 = _randn(8, 2, cfg.lru_width)
    jx = jnp.asarray(x, dt)
    jstate = {"conv": jnp.asarray(conv, jnp.bfloat16), "lru": jnp.asarray(h0)}
    jout, jst = jrglru.rec_mix(jx, jp, cfg_j, JSINGLE, state=jstate)
    state = {"conv": torch.from_numpy(conv).to(torch.bfloat16), "lru": torch.from_numpy(h0)}
    out, st = rglru.rec_mix(torch.from_numpy(x).to(getattr(torch, dtype)), p, cfg, SINGLE,
                            state=state)
    pairs = [(out, jout), (st["conv"], jst["conv"]), (st["lru"], jst["lru"])]
    for got, want in pairs:
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        if dtype == "bfloat16":
            C.assert_bf16_close(got, want)
        else:
            tol = TOL if s == 1 else SCAN_TOL
            np.testing.assert_allclose(C.to_np(got), C.to_np(want), **tol)


# -- the whole model ----------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    cfg, cfg_j = _cfgs()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jrglru.init_lm(cfg_j, jax.random.PRNGKey(0)))
    return cfg, cfg_j, jp, convert.from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


def _assert_cache_close(got, want):
    got, want = tree_paths(got), tree_paths(want)
    assert set(got) == set(want)
    for name, leaf in got.items():
        assert str(leaf.dtype).removeprefix("torch.") == str(want[name].dtype), name
        C.assert_f32_close(leaf, want[name], bf16_leaf=leaf.dtype == torch.bfloat16)


def test_prefill_rolls_the_trailing_window(model):
    """s = 80 over a 64-slot window: logits and every cache leaf at 1e-4
    of the reference's, and the attention block's cache holds positions
    16..79 rolled by 80 % 64 = 16, so that slot j holds position
    64 + j for j < 16 and position j above (slot = pos % window). The
    positions' k come from a prefill without a window (the group's first
    attention block reads only the rec blocks below it, so its k do not
    depend on the window), whose cache keeps all 80 in order."""
    cfg, cfg_j, jp, m = model
    tok = _tokens(0, 2, 80, cfg.vocab_size)
    jl, jc = jrglru.prefill(jp, jnp.asarray(tok), cfg_j, JSINGLE, 128)
    pl, pc = rglru.prefill(m, torch.from_numpy(tok), cfg, SINGLE, 128)
    C.assert_f32_close(pl, jl)
    _assert_cache_close(pc, jc)
    w = cfg.sliding_window
    ring = pc["groups"]["b2"]["k"]
    assert ring.shape == (1, 2, w, cfg.num_kv_heads, cfg.head_dim)
    flat = dataclasses.replace(cfg, sliding_window=None)
    _, straight = rglru.prefill(m, torch.from_numpy(tok), flat, SINGLE, 128)
    ks = straight["groups"]["b2"]["k"]
    assert ks.shape[2] == 80
    pos = [64 + j if j < 16 else j for j in range(w)]
    assert torch.equal(ring, ks[:, :, pos])


def test_decode_across_the_ring_wrap(model):
    """Three decode steps from the 80-token prefill's cache cast to
    float32 (positions 80-82, slots 16-18 of the 64-slot ring), logits
    and caches at 1e-4; then the reference's decode-after-prefill oracle
    on the port: 4 gold tokens decoded after a 76-token prefill (the
    ring wrapped) reproduce the 80-token prefill's logits within 0.05."""
    cfg, cfg_j, jp, m = model
    tok = _tokens(0, 2, 80, cfg.vocab_size)
    jl, jc = jrglru.prefill(jp, jnp.asarray(tok), cfg_j, JSINGLE, 128)
    jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
    pc = C.to_torch(jc)
    jdecode = jax.jit(lambda p, t, c, pos: jrglru.decode_step(p, t, c, pos, cfg_j, JSINGLE,
                                                               JServePlan()))
    for i in range(3):
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.asarray(80 + i))
        pl, pc = rglru.decode_step(m, torch.from_numpy(nxt), pc, 80 + i, cfg, SINGLE, None)
        C.assert_f32_close(pl, jl)
        _assert_cache_close(pc, jc)

    _, cache = rglru.prefill(m, torch.from_numpy(tok[:, :76]), cfg, SINGLE, 128)
    for i in range(4):
        ld, cache = rglru.decode_step(m, torch.from_numpy(tok[:, 76 + i : 77 + i]), cache,
                                      76 + i, cfg, SINGLE, None)
    full, _ = rglru.prefill(m, torch.from_numpy(tok), cfg, SINGLE, 128)
    np.testing.assert_allclose(ld.numpy(), full.numpy(), rtol=0.05, atol=0.05)


def test_short_prompt_leaves_an_s_slot_cache(model):
    """The reference's prefill of a prompt shorter than the window writes
    an s-slot window cache, not the w slots of ``init_cache``; the port
    copies that (ROADMAP queue 3)."""
    cfg, cfg_j, jp, m = model
    tok = _tokens(1, 2, 20, cfg.vocab_size)
    _, jc = jrglru.prefill(jp, jnp.asarray(tok), cfg_j, JSINGLE, 128)
    _, pc = rglru.prefill(m, torch.from_numpy(tok), cfg, SINGLE, 128)
    assert pc["groups"]["b2"]["k"].shape[2] == jc["groups"]["b2"]["k"].shape[2] == 20
    assert rglru.init_cache(cfg, 2, 128, device="cpu")["groups"]["b2"]["k"].shape[2] == 64
    _assert_cache_close(pc, jc)


def test_init_and_convert(model):
    """The port's seeded init has the reference's tree (paths, shapes,
    dtypes; ``tail`` a list of one rec block), its deterministic leaves
    and ``lam`` in the Griffin range; ``from_jax`` and
    ``to_reference_tree`` are bit for bit both ways."""
    cfg, cfg_j, _, _ = model
    jp = jrglru.init_lm(cfg_j, jax.random.PRNGKey(1))
    back = convert.to_reference_tree(convert.from_jax(jax.tree.map(np.asarray, jp), cfg,
                                                      device="cpu"))
    own = convert.stacked_tree(rglru.init_lm(cfg, 0, device="cpu"))
    assert isinstance(back["tail"], list) and len(back["tail"]) == 1
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
        if name.rsplit(".", 1)[-1] in ("scale", "b_r", "b_i", "conv_b"):
            np.testing.assert_array_equal(mine[name].numpy(), want)
    a = torch.exp(-8.0 * torch.nn.functional.softplus(own["groups"]["b0"]["mix"]["lru"]["lam"]))
    assert bool(((a > 0.9 - 1e-4) & (a < 0.999 + 1e-4)).all())


def test_convert_keeps_an_empty_tail():
    """A depth that is a whole number of groups leaves the reference an
    empty ``tail`` list: the port's stacked tree keeps it, so the CORE
    checkpoint walks the same tree."""
    cfg, cfg_j = _cfgs(num_layers=3)
    jp = jrglru.init_lm(cfg_j, jax.random.PRNGKey(2))
    assert jp["tail"] == []
    model = convert.from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    back = convert.to_reference_tree(model)
    assert back["tail"] == [] and len(model.groups) == 1
    assert set(tree_paths(back)) == set(tree_paths(jp))
