"""The port's fused selective scan (K8) against the JAX package's.

On the CPU the wrapper runs its plain torch version (a loop over t in
f32); the JAX side runs the Pallas kernel in interpret mode over the
sweep of tests/test_selective_scan_kernel.py, and, with an initial state
and the final state returned, the chunk body of models/mamba.py
(``_chunk_scan`` and the output einsum). Tolerance rtol = atol = 2e-5,
that of tests/test_selective_scan_kernel.py: f32 sums over n taken in
another order. The CUDA kernel is held against the plain version on the
card by tests/test_torch_cuda.py.
"""

import importlib
import itertools

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.models import mamba as jmamba  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.selective_scan import selective_scan  # noqa: E402

ssk = importlib.import_module("repro.kernels.selective_scan")

TOL = dict(rtol=2e-5, atol=2e-5)
# s, d, n, seed: the decode step's few tokens (S in {1, 2, 3}) and N from
# a scalar to a warp's lanes, at D a multiple of the Pallas kernel's bd
SWEEP = list(itertools.product((1, 2, 3, 8, 32, 64), (8, 16), (1, 4, 16, 32), (0, 1)))


def _inputs(b, s, d, n, seed):
    """The JAX test's distributions: da in U(0.6, 0.999), dbu and cm
    standard normal."""
    rng = np.random.default_rng(seed)
    da = rng.uniform(0.6, 0.999, (b, s, d, n)).astype(np.float32)
    dbu = rng.standard_normal((b, s, d, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return da, dbu, cm


@pytest.fixture(scope="module")
def jax_sweep():
    """The Pallas kernel (interpret mode) over the whole sweep, once."""
    out = {}
    for case in SWEEP:
        s, d, n, seed = case
        da, dbu, cm = _inputs(2, s, d, n, seed)
        out[case] = np.asarray(ssk.selective_scan(jnp.asarray(da), jnp.asarray(dbu),
                                                  jnp.asarray(cm), bs=min(32, s), bd=8))
    return out


@pytest.mark.parametrize("s,d,n,seed", SWEEP)
def test_plain_matches_pallas_kernel(s, d, n, seed, jax_sweep):
    da, dbu, cm = _inputs(2, s, d, n, seed)
    _build.reset_launches()
    got = selective_scan(torch.from_numpy(da), torch.from_numpy(dbu), torch.from_numpy(cm))
    assert got.shape == (2, s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_sweep[(s, d, n, seed)], **TOL)
    assert _build.LAUNCHES["selective_scan"] == 0  # a CPU tensor never launches


@pytest.mark.parametrize("b,s,d,n", [(1, 16, 32, 8), (2, 10, 16, 16), (4, 1, 64, 16),
                                     (3, 7, 8, 4), (32, 1, 12, 1), (32, 2, 12, 2),
                                     (32, 1, 12, 32), (32, 2, 12, 32), (4, 1, 12, 16),
                                     (4, 2, 12, 16), (1, 2, 12, 1)])
def test_carry_matches_chunk_scan(b, s, d, n):
    """h0 in, h_last out: the reference's chunk body, ``_chunk_scan``
    then ``einsum("bcdn,bcn->bcd")`` (models/mamba.py:174-175); the
    decode step's shapes too (S in {1, 2}, a D of 12 that fills no block
    of the CUDA bodies, N from 1 to 32, B up to 32)."""
    da, dbu, cm = _inputs(b, s, d, n, b * 100 + s)
    h0 = np.random.default_rng(s).standard_normal((b, d, n)).astype(np.float32)
    h_all, h_last = jmamba._chunk_scan(jnp.asarray(da), jnp.asarray(dbu), jnp.asarray(h0))
    want_y = np.asarray(jnp.einsum("bcdn,bcn->bcd", h_all, jnp.asarray(cm)))
    y, h = selective_scan(torch.from_numpy(da), torch.from_numpy(dbu), torch.from_numpy(cm),
                          h0=torch.from_numpy(h0), return_state=True)
    assert h.shape == (b, d, n)
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_last), **TOL)


def test_zero_h0_is_the_default():
    da, dbu, cm = (torch.from_numpy(a) for a in _inputs(2, 8, 8, 4, 3))
    y0, h0 = selective_scan(da, dbu, cm, return_state=True)
    y1, h1 = selective_scan(da, dbu, cm, h0=torch.zeros(2, 8, 4), return_state=True)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)


def _bad_operands():
    da, dbu, cm = (torch.from_numpy(a) for a in _inputs(2, 8, 16, 4, 0))
    wide = torch.from_numpy(_inputs(1, 8, 16, 8, 0)[2])  # (1, 8, 8): cm split out of it
    return {
        "rank": ((da[0], dbu[0], cm), {}, "da must be"),
        "dtype": ((da.double(), dbu.double(), cm.double()), {}, "float32"),
        "dbu_shape": ((da, dbu[:, :4], cm), {}, "dbu"),
        "cm_shape": ((da, dbu, cm[:, :, :2]), {}, "cm must be"),
        "h0_shape": ((da, dbu, cm), {"h0": torch.zeros(2, 16, 5)}, "h0 must be"),
        "n_not_pow2": ((da[..., :3].contiguous(), dbu[..., :3].contiguous(), cm[..., :3]
                        .contiguous()), {}, "power of two"),
        "n_too_big": ((torch.ones(1, 2, 2, 64), torch.ones(1, 2, 2, 64), torch.ones(1, 2, 64)),
                      {}, "power of two"),
        "strided_cm": ((da[:1], dbu[:1], wide[..., :4]), {}, "contiguous"),
        "strided_da": ((da.transpose(2, 3).contiguous().transpose(2, 3), dbu, cm), {},
                       "contiguous"),
        "empty": ((da[:, :0], dbu[:, :0], cm[:, :0]), {}, "empty"),
    }


@pytest.mark.parametrize("case", sorted(_bad_operands()))
def test_wrapper_raises_on_bad_operands(case):
    args, kw, match = _bad_operands()[case]
    with pytest.raises(ValueError, match=match):
        selective_scan(*args, **kw)
