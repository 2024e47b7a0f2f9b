"""The port's coding layer and CORE codec against the JAX package,
byte for byte (tolerance 0): GF(2^8) tables and host matrix helpers,
RS/LRC generators, LinearCode encode/decode/repair on random erasures,
and CoreCodec encode/repair/verify. The port runs on the CPU
(``device="cpu"``); inputs come from numpy seeds and go to both."""

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.coding import gf256 as jgf  # noqa: E402
from repro.coding import lrc as jlrc  # noqa: E402
from repro.coding import rs as jrs  # noqa: E402
from repro.core.product_code import CoreCode as JCoreCode  # noqa: E402
from repro.core.product_code import CoreCodec as JCoreCodec  # noqa: E402
from repro_torch.coding import gf256, lrc, rs, spc  # noqa: E402
from repro_torch.core.product_code import CoreCode, CoreCodec  # noqa: E402


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_tables_identical():
    for name in ("_EXP_NP", "_LOG_NP", "_MUL_NP", "_INV_NP"):
        ours, theirs = getattr(gf256, name), getattr(jgf, name)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("seed", range(3))
def test_host_matrix_helpers_identical(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    b = rng.integers(0, 256, (7, 4), dtype=np.uint8)
    np.testing.assert_array_equal(gf256.np_matmul(a, b), jgf.np_matmul(a, b))
    sq = rs.generator_matrix(12, 6)[rng.permutation(12)[:6]]  # invertible
    np.testing.assert_array_equal(gf256.np_inv_matrix(sq), jgf.np_inv_matrix(sq))
    with pytest.raises(np.linalg.LinAlgError):
        gf256.np_inv_matrix(np.zeros((3, 3), dtype=np.uint8))


@pytest.mark.parametrize("seed", range(3))
def test_elementwise_and_matmul_identical(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (3, 64), dtype=np.uint8)
    b = rng.integers(0, 256, (3, 64), dtype=np.uint8)
    np.testing.assert_array_equal(
        _np(gf256.mul(torch.from_numpy(a), torch.from_numpy(b))),
        np.asarray(jgf.mul(jnp.asarray(a), jnp.asarray(b))),
    )
    np.testing.assert_array_equal(
        _np(gf256.inv(torch.from_numpy(a))), np.asarray(jgf.inv(jnp.asarray(a)))
    )
    coef = rng.integers(0, 256, (4, 6), dtype=np.uint8)
    data = rng.integers(0, 256, (2, 6, 200), dtype=np.uint8)  # batched
    np.testing.assert_array_equal(
        _np(gf256.matmul(coef, torch.from_numpy(data))),
        np.asarray(jgf.matmul(jnp.asarray(coef), jnp.asarray(data))),
    )
    np.testing.assert_array_equal(
        _np(gf256.xor_reduce(torch.from_numpy(data), axis=1)),
        np.asarray(jgf.xor_reduce(jnp.asarray(data), axis=1)),
    )


@pytest.mark.parametrize("n,k", [(9, 6), (14, 12), (16, 12)])
def test_rs_generator_identical(n, k):
    np.testing.assert_array_equal(rs.generator_matrix(n, k), jrs.generator_matrix(n, k))
    np.testing.assert_array_equal(rs.parity_matrix(n, k), jrs.parity_matrix(n, k))


@pytest.mark.parametrize("n,k", [(16, 12), (10, 6), (8, 6)])
def test_lrc_generator_identical(n, k):
    np.testing.assert_array_equal(lrc.generator_matrix(n, k), jlrc.generator_matrix(n, k))
    ours, theirs = lrc.make_lrc(n, k), jlrc.make_lrc(n, k)
    failed = {0, k}
    assert ours.repair_plan(failed) == theirs.repair_plan(failed)


@pytest.mark.parametrize(
    "family,n,k,seed",
    [("rs", 9, 6, 0), ("rs", 14, 12, 1), ("rs", 16, 12, 2), ("lrc", 16, 12, 3)],
)
def test_linear_code_encode_decode_repair_identical(family, n, k, seed):
    rng = np.random.default_rng(seed)
    ours = (rs.make_rs if family == "rs" else lrc.make_lrc)(n, k)
    theirs = (jrs.make_rs if family == "rs" else jlrc.make_lrc)(n, k)
    data = rng.integers(0, 256, (k, 96), dtype=np.uint8)
    cw = _np(ours.encode(data, "cpu"))
    np.testing.assert_array_equal(cw, np.asarray(theirs.encode(jnp.asarray(data))))
    for _ in range(4):
        lost = rng.choice(n, size=int(rng.integers(1, n - k + 1)), replace=False)
        avail = np.asarray(sorted(set(range(n)) - set(lost.tolist())))
        if not theirs.decodable(avail):
            continue
        assert ours.decodable(avail)
        dec = _np(ours.decode(avail, cw[avail], "cpu"))
        np.testing.assert_array_equal(
            dec, np.asarray(theirs.decode(avail, jnp.asarray(cw[avail])))
        )
        np.testing.assert_array_equal(dec, data)
        rep = _np(ours.repair(avail, cw[avail], np.sort(lost), "cpu"))
        np.testing.assert_array_equal(
            rep,
            np.asarray(theirs.repair(avail, jnp.asarray(cw[avail]), np.sort(lost))),
        )
        np.testing.assert_array_equal(rep, cw[np.sort(lost)])


def test_spc_parity_and_repair():
    rng = np.random.default_rng(4)
    blocks = torch.from_numpy(rng.integers(0, 256, (3, 50), dtype=np.uint8))
    par = spc.parity(blocks)
    np.testing.assert_array_equal(_np(spc.repair(torch.stack([blocks[0], blocks[2], par]))),
                                  _np(blocks[1]))
    np.testing.assert_array_equal(spc.make_spc(3).gen[-1], np.ones(3, dtype=np.uint8))


@pytest.mark.parametrize("n,k,t,seed", [(9, 6, 3, 0), (14, 12, 5, 1), (6, 4, 2, 2)])
def test_core_codec_identical(n, k, t, seed):
    rng = np.random.default_rng(seed)
    ours, theirs = CoreCodec(CoreCode(n, k, t), device="cpu"), JCoreCodec(JCoreCode(n, k, t))
    objs = rng.integers(0, 256, (t, k, 128), dtype=np.uint8)
    mat = _np(ours.encode(objs))
    assert mat.shape == (t + 1, n, 128)
    np.testing.assert_array_equal(mat, np.asarray(theirs.encode(jnp.asarray(objs))))
    assert ours.verify(mat) and theirs.verify(jnp.asarray(mat))
    bad = mat.copy()
    bad[1, 2, 5] ^= 0x40
    assert not ours.verify(bad) and not theirs.verify(jnp.asarray(bad))
    # vertical: column c of row r from the other t rows
    r, c = int(rng.integers(t + 1)), int(rng.integers(n))
    col = np.delete(mat[:, c], r, axis=0)
    got = _np(ours.repair_vertical(col))
    np.testing.assert_array_equal(got, np.asarray(theirs.repair_vertical(jnp.asarray(col))))
    np.testing.assert_array_equal(got, mat[r, c])
    # horizontal: m lost columns of a row from the rest
    lost = np.sort(rng.choice(n, size=n - k, replace=False))
    avail = np.asarray(sorted(set(range(n)) - set(lost.tolist())))
    got = _np(ours.repair_horizontal(mat[r, avail], avail, lost))
    np.testing.assert_array_equal(
        got, np.asarray(theirs.repair_horizontal(jnp.asarray(mat[r, avail]), avail, lost))
    )
    np.testing.assert_array_equal(got, mat[r, lost])
    if r < t:
        np.testing.assert_array_equal(_np(ours.decode_object(mat[r, avail], avail)), objs[r])
