"""The port's Reed-Solomon and LRC codecs against the JAX package's: the
cases of tests/test_rs_lrc.py run on both, with identical generators,
codewords, decodes, repairs and LRC repair plans byte for byte. The
port's linear codes run on CPU tensors (their plain torch path)."""

from __future__ import annotations

import itertools

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.coding.linear as jlin  # noqa: E402
import repro.coding.lrc as jlrc  # noqa: E402
import repro.coding.rs as jrs  # noqa: E402
import repro_torch.coding.linear as tlin  # noqa: E402
import repro_torch.coding.lrc as tlrc  # noqa: E402
import repro_torch.coding.rs as trs  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves, and the
    suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _both_encode(jcode, tcode, data):
    ref = np.asarray(jcode.encode(jnp.asarray(data)))
    port = tcode.encode(_t(data)).numpy()
    assert np.array_equal(port, ref)
    return port


@pytest.mark.parametrize("n,k", [(5, 3), (9, 6), (14, 12), (10, 6)])
def test_rs_systematic_and_mds(n, k):
    code, ref = trs.make_rs(n, k), jrs.make_rs(n, k)
    assert np.array_equal(code.gen, ref.gen)
    assert np.array_equal(code.gen[:k], np.eye(k, dtype=np.uint8))
    for subset in itertools.combinations(range(n), k):
        rank = tlin.rank_gf256(code.gen[list(subset)])
        assert rank == jlin.rank_gf256(ref.gen[list(subset)]) == k, subset


@pytest.mark.parametrize("n,k", [(9, 6), (14, 12)])
def test_rs_encode_decode_roundtrip(n, k):
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, size=(k, 64), dtype=np.uint8)
    code, ref = trs.make_rs(n, k), jrs.make_rs(n, k)
    cw = _both_encode(ref, code, data)
    assert cw.shape == (n, 64) and np.array_equal(cw[:k], data)
    for _ in range(10):
        erased = rng.choice(n, size=n - k, replace=False)
        avail = np.setdiff1d(np.arange(n), erased)
        dec = code.decode(avail, _t(cw[avail])).numpy()
        assert np.array_equal(dec, np.asarray(ref.decode(avail, jnp.asarray(cw[avail]))))
        assert np.array_equal(dec, data)


def test_rs_repair_specific_blocks():
    n, k = 9, 6
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, size=(k, 32), dtype=np.uint8)
    code, ref = trs.make_rs(n, k), jrs.make_rs(n, k)
    cw = _both_encode(ref, code, data)
    missing = np.asarray([2, 7])
    avail = np.setdiff1d(np.arange(n), missing)
    rep = code.repair(avail, _t(cw[avail]), missing).numpy()
    assert np.array_equal(rep, np.asarray(ref.repair(avail, jnp.asarray(cw[avail]), missing)))
    assert np.array_equal(rep, cw[missing])
    rows, coeffs = code.repair_matrix(avail, missing)
    ref_rows, ref_coeffs = ref.repair_matrix(avail, missing)
    assert np.array_equal(rows, ref_rows) and np.array_equal(coeffs, ref_coeffs)


@given(st.integers(min_value=2, max_value=12), st.data())
@settings(max_examples=25, deadline=None)
def test_rs_any_k_of_n_property(k, data_st):
    n = data_st.draw(st.integers(min_value=k, max_value=min(k + 6, 18)))
    rng = np.random.default_rng(k * 31 + n)
    data = rng.integers(0, 256, size=(k, 8), dtype=np.uint8)
    code, ref = trs.make_rs(n, k), jrs.make_rs(n, k)
    cw = _both_encode(ref, code, data)
    avail = np.sort(rng.choice(n, size=k, replace=False))
    dec = code.decode(avail, _t(cw[avail])).numpy()
    assert np.array_equal(dec, np.asarray(ref.decode(avail, jnp.asarray(cw[avail]))))
    assert np.array_equal(dec, data)


# ---------------------------------------------------------------------------
# LRC
# ---------------------------------------------------------------------------

def test_lrc_layout_and_parities():
    code, ref = tlrc.make_lrc(10, 6), jlrc.make_lrc(10, 6)
    assert np.array_equal(code.gen, ref.gen)
    data = np.random.default_rng(9).integers(0, 256, size=(6, 16), dtype=np.uint8)
    cw = _both_encode(ref, code, data)
    assert cw.shape == (10, 16) and np.array_equal(cw[:6], data)
    assert np.array_equal(cw[6], np.bitwise_xor.reduce(data[:3], axis=0))
    assert np.array_equal(cw[7], np.bitwise_xor.reduce(data[3:], axis=0))


@pytest.mark.parametrize("failed", [{1}, {8}, {1, 4, 8}, {0, 6}, {2, 3}, {6, 7, 9}],
                         ids=str)
def test_lrc_repair_plans_equal(failed):
    code, ref = tlrc.make_lrc(10, 6), jlrc.make_lrc(10, 6)
    assert code.repair_plan(set(failed)) == ref.repair_plan(set(failed))


def test_lrc_paper_examples():
    code = tlrc.make_lrc(10, 6)
    (kind, sources, repaired), = code.repair_plan({1})
    assert kind == "local" and repaired == [1] and sorted(sources) == [0, 2, 6]
    (kind, sources, _), = code.repair_plan({8})
    assert kind == "global" and len(sources) == 6


def test_lrc_tolerates_m_minus_2_always():
    code, ref = tlrc.make_lrc(10, 6), jlrc.make_lrc(10, 6)
    for erased in itertools.combinations(range(10), 2):
        avail = np.setdiff1d(np.arange(10), erased)
        assert code.decodable(avail) and ref.decodable(avail), erased


def test_lrc_avg_single_repair_cost_formula():
    n, k = 10, 6
    direct = (k + 2) / n * (k / 2) + (n - k - 2) / n * k
    assert tlrc.avg_single_repair_cost(n, k) == jlrc.avg_single_repair_cost(n, k)
    assert abs(tlrc.avg_single_repair_cost(n, k) - direct) < 1e-12


def test_lrc_repair_plan_executes_correctly():
    code, ref = tlrc.make_lrc(10, 6), jlrc.make_lrc(10, 6)
    data = np.random.default_rng(10).integers(0, 256, size=(6, 16), dtype=np.uint8)
    cw = _both_encode(ref, code, data)
    failed = {1, 4, 8}
    store = {i: cw[i] for i in range(10) if i not in failed}
    for kind, sources, repaired in code.repair_plan(set(failed)):
        assert all(s in store for s in sources)
        stack = np.stack([store[s] for s in sources])
        if kind == "local":
            (tgt,) = repaired
            store[tgt] = np.bitwise_xor.reduce(stack, axis=0)
        else:
            dec = code.decode(np.asarray(sources), _t(stack)).numpy()
            assert np.array_equal(
                dec, np.asarray(ref.decode(np.asarray(sources), jnp.asarray(stack))))
            full = _both_encode(ref, code, dec)
            for t in repaired:
                store[t] = full[t]
    for i in range(10):
        assert np.array_equal(store[i], cw[i]), i
