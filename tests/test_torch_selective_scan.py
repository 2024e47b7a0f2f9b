"""The port's fused selective scan (K8) against the JAX package's.

On the CPU the wrapper runs its plain torch version (a loop over t in
f32); the JAX side runs the Pallas kernel in interpret mode over the
sweep of tests/test_selective_scan_kernel.py, and, with an initial state
and the final state returned, the chunk body of models/mamba.py
(``_chunk_scan`` and the output einsum), and at N = 1 the JAX package's
``rglru_scan``. ``scan_plan``, the kernel's launch, is checked here
too: every column covered once, the ring body's stages and shared
memory, the float4 body for N >= 4. Tolerance rtol = atol = 2e-5,
that of tests/test_selective_scan_kernel.py: f32 sums over n taken in
another order. The CUDA kernel is held against the plain version on the
card by tests/test_torch_cuda.py.
"""

import importlib
import itertools
import pathlib
import re

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import selective_scan as ssk_t  # noqa: E402
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


# -- scan_plan: K8's launch shape, where the CPU tests reach it ---------------

PLAN_B = (1, 4, 32)
PLAN_S = (1, 15, 16, 17, 31, 33, 48, 49, 127, 128, 129, 2048, 4099, 32768)
PLAN_D = (1, 12, 200, 1000, 4096, 8192)
SMEM_LIMIT = 232448  # 227 KB: the most shared memory one block of an H100 can take


def _plan_coverage(plan, b, d, n):
    """How often each (b, d, n) column is covered by ``plan``'s grid.
    Block x covers the ``per_block`` contiguous columns from x *
    per_block, columns counted d * N + n within one b (the float4 body:
    thread t of block x takes columns 4 * (x * 256 + t) to + 3; the ring
    body: lane l of block x takes column x * 32 + l), and blockIdx.y is b;
    the C entry launches this grid and refuses one that fails here."""
    per_block = 4 * ssk_t.VEC_THREADS if plan.body == ssk_t.BODY_VEC else ssk_t.RING_COLS
    gx, gy = plan.grid
    assert gy == b
    assert (gx - 1) * per_block < d * n, "an idle block"
    count = np.zeros((gy, d * n), dtype=np.int64)
    for x in range(gx):
        count[:, x * per_block:(x + 1) * per_block] += 1
    return count


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32])
def test_scan_plan_covers_every_column_once(n):
    """Every (b, d, n) column of every shape lies in exactly one block's
    range, and no block lies wholly past the last column (the last one may
    reach past it: the ring body's spare lanes repeat the last column, the
    float4 body masks its lanes)."""
    for b, s, d in itertools.product(PLAN_B, PLAN_S, PLAN_D):
        count = _plan_coverage(ssk_t.scan_plan(b, s, d, n), b, d, n)
        assert (count == 1).all(), (b, s, d, n)


@pytest.mark.parametrize("n", [1, 2])
def test_scan_plan_ring_body_shape(n):
    """For N in {1, 2} the ring body at every S: 4 stages while its warps,
    one stage each, hold less than RING_ONE_AHEAD_BYTES, else 2, whatever
    S; both counts occur over the sweep, and the shared memory the C entry
    gives a block (stages x RING_STAGE_BYTES) stays within the 48 KB a
    launch takes without opting in, and so within the 227 KB a block can
    take."""
    stages = set()
    for b, s, d in itertools.product(PLAN_B, PLAN_S, PLAN_D):
        plan = ssk_t.scan_plan(b, s, d, n)
        assert plan.body == ssk_t.BODY_RING, (b, s, d, n)
        warps = plan.grid[0] * b
        assert plan.stages == (4 if warps * ssk_t.RING_STAGE_BYTES
                               < ssk_t.RING_ONE_AHEAD_BYTES else 2)
        assert plan == ssk_t.scan_plan(b, 1, d, n)
        assert 0 < plan.stages * ssk_t.RING_STAGE_BYTES <= min(48 * 1024, SMEM_LIMIT)
        stages.add(plan.stages)
    assert stages == {2, 4}
    # the RG-LRU prefill's (1, S, 4096, 1): 128 warps, 4 stages
    assert ssk_t.scan_plan(1, 2048, 4096, 1) == (ssk_t.BODY_RING, 4, (128, 1))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_scan_plan_float4_body_for_n_from_4(n):
    """For every N >= 4 the float4 body, no stages, and the grid the .cu's
    launch_n computes for it: D over 256 / (N / 4) channels a block."""
    for b, s, d in itertools.product(PLAN_B, PLAN_S, PLAN_D):
        plan = ssk_t.scan_plan(b, s, d, n)
        assert plan == (ssk_t.BODY_VEC, 0, (-(-d // (ssk_t.VEC_THREADS // (n // 4))), b))


def test_scan_plan_numbers_match_the_source():
    """The constants ``scan_plan`` shares with csrc/selective_scan.cu, and
    an instance of the ring body for each stage count it picks."""
    src = (pathlib.Path(ssk_t.__file__).parent / "csrc" / "selective_scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRingSteps") == ssk_t.RING_STEPS
    assert const("kRingCols") == ssk_t.RING_COLS
    assert const("kVecThreads") == ssk_t.VEC_THREADS
    assert (const("kBodyVec"), const("kBodyRing")) == (ssk_t.BODY_VEC, ssk_t.BODY_RING)
    assert "selective_scan_kernel_ring<N, K, true><<<grid, 32," in src
    assert "kStageFloats = 2 * kRingSteps * kRingCols + 32;" in src
    assert ssk_t.RING_STAGE_BYTES == 4 * (2 * ssk_t.RING_STEPS * ssk_t.RING_COLS + 32)
    for k in (2, 4):
        for n in (1, 2):
            assert f"case {16 * n} + {k}: launch_ring<{n}, {k}>" in src


@pytest.mark.parametrize("s", [1, 15, 17, 33, 100])
def test_plain_at_n1_matches_rglru_scan(s):
    """K8's function at N = 1 with cm = 1 is the RG-LRU recurrence: its
    plain version, on the a and b of the JAX package's gates, equals the
    JAX package's ``rglru_scan`` (a chunked associative scan) within the
    K8 tolerance, at lengths that fill no whole stage of the ring body."""
    cfg = jconfigs.get_config("recurrentgemma_9b").reduced()
    jp = jrglru.init_rglru(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.lru_width)).astype(np.float32)
    h0 = rng.standard_normal((2, cfg.lru_width)).astype(np.float32)
    jy, jh = jrglru.rglru_scan(jnp.asarray(x), jp, cfg, jnp.asarray(h0))
    log_a, gated = jrglru._gates(jnp.asarray(x), jp, cfg)
    a = np.array(jnp.exp(log_a))
    bt = np.array(jnp.sqrt(jnp.maximum(1.0 - jnp.exp(2.0 * log_a), 1e-12)) * gated)
    y, h = selective_scan(torch.from_numpy(a)[..., None], torch.from_numpy(bt)[..., None],
                          torch.ones((2, s, 1)), h0=torch.from_numpy(h0)[..., None],
                          return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h[..., 0].numpy(), np.asarray(jh), **TOL)
