"""Numerics oracles for the chunked and scanned paths, on both packages:
the twin of tests/test_scan_oracles.py. Each case runs the reference's oracle on the JAX
package and the same oracle, in torch, on the port, from the same
numpy-seeded inputs, and holds the two packages' results together.

Tolerances are the reference test's (2e-5 for attention, 2e-4 for the
scan) and, between the packages, the same.
"""

import math

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.shardings import SINGLE as JSINGLE  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba, rglru  # noqa: E402
from repro_torch.models.shardings import SINGLE  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _naive_causal_attention_jax(q, k, v, window=None):
    b, s, h, d = q.shape
    scores = jnp.einsum("bqhd,bthd->bhqt", q, k).astype(jnp.float32) / math.sqrt(d)
    pos = np.arange(s)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    scores = jnp.where(jnp.asarray(mask)[None, None], scores, -1e30)
    w = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    return jnp.einsum("bhqt,bthd->bqhd", w, v).reshape(b, s, h * d)


def _naive_causal_attention_torch(q, k, v, window=None):
    b, s, h, d = q.shape
    scores = torch.einsum("bqhd,bthd->bhqt", q, k).float() / math.sqrt(d)
    pos = torch.arange(s)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    scores = torch.where(mask[None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqt,bthd->bqhd", w, v).reshape(b, s, h * d)


@settings(max_examples=12, deadline=None)
@given(
    s=st.sampled_from([8, 24, 64]),
    chunk=st.sampled_from([4, 8, 16, 64]),
    window=st.sampled_from([None, 4, 16]),
)
def test_chunked_attention_matches_naive(s, chunk, window):
    kw = dict(num_layers=1, attn_chunk=chunk, sliding_window=window)
    cfg_j = jconfigs.get_config("qwen2_72b").reduced(**kw)
    cfg = configs.get_config("qwen2_72b").reduced(**kw)
    rng = np.random.default_rng(s * 100 + chunk)
    q, k, v = (rng.standard_normal((2, s, 4, 16)).astype(np.float32) for _ in range(3))
    jgot = JL.attention_core_train(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg_j,
                                   JSINGLE)
    jwant = _naive_causal_attention_jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window)
    np.testing.assert_allclose(np.asarray(jgot), np.asarray(jwant), atol=2e-5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = L.attention_core_train(tq, tk, tv, cfg, SINGLE).numpy()
    np.testing.assert_allclose(got, _naive_causal_attention_torch(tq, tk, tv, window).numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jgot), atol=2e-5)


def _naive_selective_scan(da, dbu, cm):
    b, s, di, n = da.shape
    h = np.zeros((b, di, n), np.float32)
    ys = []
    for t in range(s):
        h = np.asarray(da[:, t]) * h + np.asarray(dbu[:, t])
        ys.append(np.einsum("bdn,bn->bd", h, np.asarray(cm[:, t])))
    return np.stack(ys, axis=1)


@settings(max_examples=8, deadline=None)
@given(s=st.sampled_from([6, 16, 32]), chunk=st.sampled_from([4, 8, 32]))
def test_mamba_chunked_scan_matches_sequential(s, chunk):
    """The chunk loop of ``mamba_mix`` under grad: ``_chunk_scan`` per
    chunk from the carried state, then the output einsum."""
    b, di, n = 2, 8, 4
    rng = np.random.default_rng(0)
    da = rng.uniform(0.7, 0.99, (b, s, di, n)).astype(np.float32)
    dbu = rng.standard_normal((b, s, di, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    nch = s // chunk if s % chunk == 0 else 1
    width = s // nch
    want = _naive_selective_scan(da, dbu, cm)

    jh, th = jnp.zeros((b, di, n), jnp.float32), torch.zeros((b, di, n))
    jys, tys = [], []
    for i in range(nch):
        sl = slice(i * width, (i + 1) * width)
        jall, jh = jmamba._chunk_scan(jnp.asarray(da[:, sl]), jnp.asarray(dbu[:, sl]), jh)
        jys.append(jnp.einsum("bcdn,bcn->bcd", jall, jnp.asarray(cm[:, sl])))
        tall, th = mamba._chunk_scan(torch.from_numpy(da[:, sl]),
                                     torch.from_numpy(dbu[:, sl]), th)
        tys.append(torch.einsum("bcdn,bcn->bcd", tall, torch.from_numpy(cm[:, sl])))
    jgot = np.asarray(jnp.concatenate(jys, axis=1))
    got = torch.cat(tys, dim=1).numpy()
    np.testing.assert_allclose(jgot, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, jgot, rtol=2e-4, atol=2e-4)


@settings(max_examples=8, deadline=None)
@given(s=st.sampled_from([5, 12, 33]), chunk=st.sampled_from([4, 16]),
       grad=st.sampled_from([False, True]))
def test_rglru_scan_matches_stepwise(s, chunk, grad):
    """The reference's oracle: ``rglru_scan`` over the prompt equals
    ``rglru_step`` token by token (2e-4). The port's scan takes K8's
    route (its plain version here) without grad and the reference's
    chunked associative scan with it; both are held to the reference's
    scan and to the port's own steps."""
    cfg_j = jconfigs.get_config("recurrentgemma_9b").reduced(scan_chunk=chunk)
    cfg = configs.get_config("recurrentgemma_9b").reduced(scan_chunk=chunk)
    jp = jrglru.init_rglru(jax.random.PRNGKey(3), cfg_j, dtype=jnp.float32)
    x = np.random.default_rng(4).standard_normal((2, s, cfg.lru_width)).astype(np.float32)

    jys, _ = jrglru.rglru_scan(jnp.asarray(x), jp, cfg_j)
    h, outs = jnp.zeros((2, cfg.lru_width), jnp.float32), []
    for t in range(s):
        y1, h = jrglru.rglru_step(jnp.asarray(x[:, t : t + 1]), jp, cfg_j, h)
        outs.append(y1)
    jwant = np.asarray(jnp.concatenate(outs, axis=1))
    np.testing.assert_allclose(np.asarray(jys), jwant, rtol=2e-4, atol=2e-4)

    p = rglru.RgLru(cfg, None, torch.float32, "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    tx = torch.from_numpy(x).requires_grad_(grad)
    ys, _ = rglru.rglru_scan(tx, p, cfg)
    assert ys.requires_grad == grad
    th, touts = torch.zeros((2, cfg.lru_width)), []
    with torch.no_grad():
        for t in range(s):
            y1, th = rglru.rglru_step(tx[:, t : t + 1], p, cfg, th)
            touts.append(y1)
    want = torch.cat(touts, dim=1).numpy()
    np.testing.assert_allclose(ys.detach().numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(want, jwant, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [None, 6])
def test_grouped_decode_attend_matches_expanded(window):
    """``_grouped_attend`` (the KV heads never expanded) equals
    ``expand_kv`` and a dense softmax, on both packages."""
    kw = dict(num_heads=8, num_kv_heads=2, sliding_window=window)
    cfg_j = jconfigs.get_config("mistral_large_123b").reduced(**kw)
    cfg = configs.get_config("mistral_large_123b").reduced(**kw)
    rng = np.random.default_rng(1)
    b, smax, hd = 2, 16, cfg.head_dim
    q = rng.standard_normal((b, 1, 8, hd)).astype(np.float32)
    ck = rng.standard_normal((b, smax, 2, hd)).astype(np.float32)
    cv = rng.standard_normal((b, smax, 2, hd)).astype(np.float32)
    jvalid = JL._ring_valid(jnp.asarray(9), smax, window)
    valid = L._ring_valid(9, smax, window)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))

    o, m, l = JL._grouped_attend(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), cfg_j,
                                 jvalid)
    jgot = np.asarray((o / l[..., None]).transpose(0, 3, 1, 2, 4).reshape(b, 1, 8 * hd))
    to, tm, tl = L._grouped_attend(torch.from_numpy(q), torch.from_numpy(ck),
                                   torch.from_numpy(cv), cfg, valid)
    got = (to / tl[..., None]).permute(0, 3, 1, 2, 4).reshape(b, 1, 8 * hd).numpy()

    ke = L.expand_kv(torch.from_numpy(ck), cfg)
    ve = L.expand_kv(torch.from_numpy(cv), cfg)
    scores = torch.einsum("bqhd,bthd->bhqt", torch.from_numpy(q), ke) / math.sqrt(hd)
    scores = torch.where(valid[None, None, None], scores, -1e30)
    want = torch.einsum("bhqt,bthd->bqhd", torch.softmax(scores, -1), ve).reshape(b, 1, 8 * hd)
    np.testing.assert_allclose(jgot, want.numpy(), atol=2e-5)
    np.testing.assert_allclose(got, want.numpy(), atol=2e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(m), atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(l), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("pos,smax,window", [(5, 16, None), (9, 4, None), (9, 4, 2),
                                             (0, 8, 3), (30, 8, 5), (7, 8, 8)])
def test_ring_valid_semantics(pos, smax, window):
    got = L._ring_valid(pos, smax, window).tolist()
    assert got == np.asarray(JL._ring_valid(jnp.asarray(pos), smax, window)).tolist()
    # slot i holds the most recent write to it: abs pos - ((pos - i) mod smax)
    for i, ok in enumerate(got):
        abs_pos = pos - (pos - i) % smax
        assert ok == (abs_pos >= 0 and (window is None or pos - abs_pos < window))


def test_ring_valid_reference_cases():
    """tests/test_scan_oracles.py's three cases, on the port."""
    assert L._ring_valid(5, 16, None).tolist() == [True] * 6 + [False] * 10
    assert L._ring_valid(9, 4, None).all()
    assert L._ring_valid(9, 4, 2).tolist() == [True, True, False, False]
