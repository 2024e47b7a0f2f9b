"""The port's single-op and batched GF(256) / XOR entries (K5, K6, K7 and
K7 batched) against the JAX package's, byte for byte (tolerance 0).

On the CPU each wrapper runs its plain torch version; the JAX side runs
the Pallas kernels in interpret mode, as tests/test_kernels*.py do. N is
kept small and mostly not a multiple of the block width, so the padding
and slicing of ``ops`` are exercised. The CUDA kernels themselves are
held against their plain versions on the card by tests/test_torch_cuda.py.
"""

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.coding import rs as jrs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.coding import rs  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.gf256_matmul import (  # noqa: E402
    DEFAULT_BLOCK_N,
    gf256_matmul_planes,
    gf256_matmul_planes_batched,
)
from repro_torch.kernels.xor_parity import xor_parity, xor_parity_batched  # noqa: E402


def _u8(rng, *shape):
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def _port(fn, *args, **kw):
    return fn(*args, **kw).cpu().numpy()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n", [128, 1000, 5000])
@pytest.mark.parametrize("m,k", [(1, 2), (2, 12), (3, 6), (4, 16), (6, 6)])
def test_gf256_matmul_matches_jax(m, k, n, packed):
    """K5 through ops.gf256_matmul, shapes of tests/test_kernels.py; M = 6
    takes the CUDA body's second accumulator pass on the card."""
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    coef, data = _u8(rng, m, k), _u8(rng, k, n)
    got = _port(ops.gf256_matmul, coef, torch.from_numpy(data), packed=packed)
    want = np.asarray(jops.gf256_matmul(coef, jnp.asarray(data), interpret=True, packed=packed))
    assert got.shape == (m, n) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [128, 777, 4096])
@pytest.mark.parametrize("t", [2, 3, 5, 13])
def test_xor_parity_matches_jax(t, n):
    rng = np.random.default_rng(t * 97 + n)
    data = _u8(rng, t, n)
    got = _port(ops.xor_parity, torch.from_numpy(data))
    want = jops.xor_parity(jnp.asarray(data), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("b,m,k,n", [(1, 1, 6, 1000), (3, 1, 6, 512), (2, 3, 6, 4999),
                                     (4, 2, 12, 256)])
def test_gf256_matmul_batched_matches_jax(b, m, k, n, packed):
    rng = np.random.default_rng(b * 7 + m * 5 + k + n)
    coefs, data = _u8(rng, b, m, k), _u8(rng, b, k, n)
    got = _port(ops.gf256_matmul_batched, coefs, torch.from_numpy(data), packed=packed)
    want = jops.gf256_matmul_batched(coefs, jnp.asarray(data), interpret=True, packed=packed)
    assert got.shape == (b, m, n)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("b,t,n", [(1, 3, 1000), (4, 3, 128), (2, 5, 4999)])
def test_xor_parity_batched_matches_jax(b, t, n):
    rng = np.random.default_rng(b * 31 + t + n)
    data = _u8(rng, b, t, n)
    got = _port(ops.xor_parity_batched, torch.from_numpy(data))
    want = jops.xor_parity_batched(jnp.asarray(data), interpret=True)
    assert got.shape == (b, n)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("block_n", [128, 512, 2048])
def test_explicit_block_n_matches_jax(block_n):
    """A caller's block_n (the autotuner's) pads to its own multiple."""
    rng = np.random.default_rng(block_n)
    coefs, data = _u8(rng, 2, 2, 6), _u8(rng, 2, 6, 3000)
    got = _port(ops.gf256_matmul_batched, coefs, torch.from_numpy(data), block_n=block_n)
    want = jops.gf256_matmul_batched(coefs, jnp.asarray(data), block_n=block_n, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    got_x = _port(ops.xor_parity_batched, torch.from_numpy(data), block_n=block_n)
    want_x = jops.xor_parity_batched(jnp.asarray(data), block_n=block_n, interpret=True)
    np.testing.assert_array_equal(got_x, np.asarray(want_x))


@pytest.mark.parametrize("n,k", [(9, 6), (14, 12)])
def test_rs_encode_decode_round_trip_matches_jax(n, k):
    """rs_encode, then n - k blocks erased and rs_decode from k
    survivors: the port's parities equal the JAX package's and the
    decode restores the data."""
    rng = np.random.default_rng(n * k)
    data = _u8(rng, k, 3000)
    pm = rs.parity_matrix(n, k)
    np.testing.assert_array_equal(pm, jrs.parity_matrix(n, k))
    parity = _port(ops.rs_encode, pm, torch.from_numpy(data))
    np.testing.assert_array_equal(
        parity, np.asarray(jops.rs_encode(pm, jnp.asarray(data), interpret=True))
    )
    stripe = np.concatenate([data, parity])
    erased = rng.choice(n, size=n - k, replace=False)
    avail = np.asarray([c for c in range(n) if c not in erased])
    row_ids, inverse = rs.make_rs(n, k).decode_matrix(avail)
    decoded = _port(ops.rs_decode, inverse, torch.from_numpy(stripe[row_ids]))
    np.testing.assert_array_equal(decoded, data)
    jdecoded = jops.rs_decode(inverse, jnp.asarray(stripe[row_ids]), interpret=True)
    np.testing.assert_array_equal(decoded, np.asarray(jdecoded))


def test_batched_rejects_mismatched_shapes():
    """The shape rejections of tests/test_kernels_batched.py, on both
    packages (the port raises ValueError where the JAX package asserts)."""
    coefs = np.zeros((2, 1, 3), dtype=np.uint8)
    with pytest.raises(AssertionError):
        jops.gf256_matmul_batched(coefs, jnp.zeros((3, 3, 128), dtype=jnp.uint8), interpret=True)
    with pytest.raises(ValueError, match="shapes differ"):
        ops.gf256_matmul_batched(coefs, torch.zeros((3, 3, 128), dtype=torch.uint8))
    with pytest.raises(ValueError, match="shapes differ"):
        ops.gf256_matmul_batched(coefs, torch.zeros((2, 4, 128), dtype=torch.uint8))
    with pytest.raises(ValueError, match="shapes differ"):
        ops.gf256_matmul(np.zeros((1, 3), np.uint8), torch.zeros((4, 128), dtype=torch.uint8))


def test_kernel_wrappers_check_their_inputs():
    d = torch.zeros((3, 256), dtype=torch.uint8)
    mc = torch.zeros((1, 3, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of block_n"):
        gf256_matmul_planes(mc, d, block_n=512)
    with pytest.raises(ValueError, match="must be"):
        gf256_matmul_planes_batched(mc, d, block_n=128)
    with pytest.raises(ValueError, match="uint8"):
        gf256_matmul_planes(mc, d.int(), block_n=128)
    with pytest.raises(ValueError, match="empty"):
        gf256_matmul_planes(mc[:0], d, block_n=128)
    with pytest.raises(ValueError, match="multiple of block_n"):
        xor_parity(d, block_n=512)
    with pytest.raises(ValueError, match=r"\(B, T, N\)"):
        xor_parity_batched(d, block_n=128)
    with pytest.raises(ValueError, match="empty"):
        xor_parity(d[:0], block_n=128)
    assert DEFAULT_BLOCK_N == 32768


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises; the
    wrapper never quietly computes the plain version."""
    calls = []
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(a[0]))
    meta = torch.zeros((2, 3, 256), dtype=torch.uint8, device="meta")
    planes = torch.zeros((2, 1, 3, 8), dtype=torch.uint8, device="meta")
    for fn in (
        lambda: gf256_matmul_planes_batched(planes, meta, block_n=128),
        lambda: gf256_matmul_planes(planes[0], meta[0], block_n=128),
        lambda: xor_parity_batched(meta, block_n=128),
        lambda: xor_parity(meta[0], block_n=128),
    ):
        with pytest.raises(ValueError, match="CUDA device or the CPU"):
            fn()
    assert not calls


def test_plain_path_counts_no_launch():
    _build.reset_launches()
    rng = np.random.default_rng(3)
    data = torch.from_numpy(_u8(rng, 2, 6, 1000))
    ops.gf256_matmul_batched(_u8(rng, 2, 1, 6), data)
    ops.gf256_matmul(_u8(rng, 3, 6), data[0])
    ops.xor_parity_batched(data)
    ops.xor_parity(data[0])
    assert all(n == 0 for n in _build.LAUNCHES.values())
    for name in ("gf256_matmul_planes", "gf256_matmul_planes_batched", "xor_parity",
                 "xor_parity_batched"):
        assert name in _build.ENTRIES and name in _build.LAUNCHES
