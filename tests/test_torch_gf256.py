"""The port's GF(2^8) arithmetic (``repro_torch.coding.gf256``) against
the JAX package's: the field-axiom and table cases of tests/test_gf256.py
run on both, with the same hypothesis settings, and every product,
inverse, matmul and XOR reduction equal byte for byte (the port on CPU
tensors)."""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.coding import gf256 as jgf  # noqa: E402
from repro_torch.coding import gf256 as tgf  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves, and the
    suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


bytes_ = st.integers(min_value=0, max_value=255)


def m(a, b):
    """The port's product, held to the reference's at every call."""
    got = int(tgf._MUL_NP[a, b])
    assert got == int(jgf._MUL_NP[a, b])
    return got


@given(bytes_, bytes_)
def test_mul_commutative(a, b):
    assert m(a, b) == m(b, a)


@given(bytes_, bytes_, bytes_)
@settings(max_examples=200)
def test_mul_associative(a, b, c):
    assert m(m(a, b), c) == m(a, m(b, c))


@given(bytes_, bytes_, bytes_)
@settings(max_examples=200)
def test_distributive(a, b, c):
    assert m(a, b ^ c) == m(a, b) ^ m(a, c)


@given(bytes_)
def test_identity_and_zero(a):
    assert m(a, 1) == a and m(a, 0) == 0


@given(st.integers(min_value=1, max_value=255))
def test_inverse(a):
    assert int(tgf._INV_NP[a]) == int(jgf._INV_NP[a])
    assert m(a, int(tgf._INV_NP[a])) == 1


def test_poly_and_scalar_helpers_equal():
    assert tgf._POLY == jgf._POLY
    for a, e in ((2, 0), (2, 7), (3, 200), (0, 5), (0x53, 254)):
        assert tgf.pow_(a, e) == jgf.pow_(a, e)
    for a, b in ((0x53, 0xCA), (0, 9), (255, 255)):
        assert tgf.mul_scalar_np(a, b) == jgf.mul_scalar_np(a, b)


def test_mul_matches_carryless_reference():
    def ref_mul(a, b):
        r = 0
        for i in range(8):
            if (b >> i) & 1:
                r ^= a << i
        for bit in range(15, 7, -1):
            if (r >> bit) & 1:
                r ^= tgf._POLY << (bit - 8)
        return r

    rng = np.random.default_rng(0)
    for _ in range(500):
        a, b = int(rng.integers(256)), int(rng.integers(256))
        assert m(a, b) == ref_mul(a, b)


def test_elementwise_mul_add_inv_equal():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, size=(64,), dtype=np.uint8)
    b = rng.integers(0, 256, size=(64,), dtype=np.uint8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tgf.mul(ta, tb).numpy()
    assert np.array_equal(got, np.asarray(jgf.mul(jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(got, tgf._MUL_NP[a, b])
    assert np.array_equal(tgf.add(ta, tb).numpy(), np.asarray(jgf.add(jnp.asarray(a),
                                                                      jnp.asarray(b))))
    nz = np.where(a == 0, 1, a).astype(np.uint8)
    assert np.array_equal(tgf.inv(torch.from_numpy(nz)).numpy(),
                          np.asarray(jgf.inv(jnp.asarray(nz))))


@pytest.mark.parametrize("shape", [(5, 7, 3), (1, 1, 1), (3, 6, 1000)])
def test_matmul_matches_np_and_reference(shape):
    mm, kk, nn = shape
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, size=(mm, kk), dtype=np.uint8)
    b = rng.integers(0, 256, size=(kk, nn), dtype=np.uint8)
    got = tgf.matmul(a, torch.from_numpy(b)).numpy()
    assert np.array_equal(got, np.asarray(jgf.matmul(jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(got, tgf.np_matmul(a, b))
    assert np.array_equal(tgf.np_matmul(a, b), jgf.np_matmul(a, b))


def test_np_inv_matrix_roundtrip():
    rng = np.random.default_rng(3)
    for n in (1, 2, 5, 12):
        while True:
            mt = rng.integers(0, 256, size=(n, n), dtype=np.uint8)
            try:
                minv = tgf.np_inv_matrix(mt)
                break
            except np.linalg.LinAlgError:
                with pytest.raises(np.linalg.LinAlgError):
                    jgf.np_inv_matrix(mt)
        assert np.array_equal(minv, jgf.np_inv_matrix(mt))
        assert np.array_equal(tgf.np_matmul(mt, minv), np.eye(n, dtype=np.uint8))


@pytest.mark.parametrize("axis", [0, 1])
def test_xor_reduce(axis):
    x = np.random.default_rng(4).integers(0, 256, size=(6, 33), dtype=np.uint8)
    got = tgf.xor_reduce(torch.from_numpy(x), axis=axis).numpy()
    assert np.array_equal(got, np.asarray(jgf.xor_reduce(jnp.asarray(x), axis=axis)))
    assert np.array_equal(got, np.bitwise_xor.reduce(x, axis=axis))
