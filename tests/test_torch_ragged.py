"""The port's tile kernels (K1-K4) and ragged coalescer against the JAX
package, byte for byte (tolerance 0).

On the CPU each kernel wrapper runs its plain torch version; the JAX side
runs the Pallas kernels in interpret mode, as its own tests do. The
coalescer comparison feeds both packages the same mixed windows (the
generator of tests/test_ragged_decode.py) and requires equal results,
equal stats counters and equal LaunchUnits, all but the measured wall
time (``compute``, ``compute_time``). The CUDA kernels themselves are
held against their plain versions on the card by tests/test_torch_cuda.py.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.gateway import coalescer as jco  # noqa: E402
from repro.gateway.planner import DecodeOp as JDecodeOp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ragged_decode as jrdk  # noqa: E402
from repro.kernels.gf256_matmul import expand_coeff_bitplanes as jexpand  # noqa: E402
from repro_torch.gateway import coalescer as tco  # noqa: E402
from repro_torch.gateway.planner import DecodeOp  # noqa: E402
from repro_torch.kernels import _build, autotune, ops, ragged_decode, ragged_encode  # noqa: E402
from repro_torch.kernels.gf256_matmul import expand_coeff_bitplanes  # noqa: E402

# (port entry, JAX entry, GF?) for K1-K4
ENTRIES = {
    "K1": (ops.gf256_ragged, jops.gf256_ragged, True),
    "K2": (ops.xor_ragged, jops.xor_ragged, False),
    "K3": (ops.gf256_ragged_encode, jops.gf256_ragged_encode, True),
    "K4": (ops.xor_ragged_encode, jops.xor_ragged_encode, False),
}


def _tiles(rng, c, kk, tn, pad):
    """Random (C, K, 8) planes and (C, K, TN) tiles; ``pad`` zeroes tile
    tails, trailing K rows and whole null tiles, as the coalescer does."""
    data = rng.integers(0, 256, (c, kk, tn), dtype=np.uint8)
    coef = rng.integers(0, 256, (c, kk), dtype=np.uint8)
    if pad:
        live_k = int(rng.integers(1, kk + 1))
        live_n = int(rng.integers(1, tn + 1))
        data[:, live_k:] = 0
        coef[:, live_k:] = 0
        data[:, :, live_n:] = 0
        data[c - 1] = 0
        coef[c - 1] = 0
    return expand_coeff_bitplanes(coef), data


def _run_port(name, mc, data, device="cpu"):
    fn, _jfn, is_gf = ENTRIES[name]
    d = torch.from_numpy(data).to(device)
    out = fn(torch.from_numpy(mc).to(device), d) if is_gf else fn(d)
    return out.cpu().numpy()


def _run_jax(name, mc, data):
    _fn, jfn, is_gf = ENTRIES[name]
    d = jnp.asarray(data)
    out = jfn(mc, d, interpret=True) if is_gf else jfn(d, interpret=True)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# kernels: plain torch version vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _card_widths(name):
    """The port's CUDA tile-width candidates for the entry's kind."""
    gf = ENTRIES[name][2]
    table = autotune.RAGGED_GF_TILE_CANDIDATES if gf else autotune.RAGGED_XOR_TILE_CANDIDATES
    return table["cuda"]


# (name, seed, width): three seeds at random shapes, then each of the
# card's tile widths at the small chunk rung (the shapes phase 5 of
# chip_smoke.py launches the CUDA kernels at, whose yardstick on the card
# is the plain version held here)
_PALLAS_CASES = [
    pytest.param(name, seed, None, id=f"{seed}-{name}")
    for seed in range(3) for name in sorted(ENTRIES)
] + [
    pytest.param(name, i, tn, id=f"card{tn}-{name}")
    for name in sorted(ENTRIES) for i, tn in enumerate(_card_widths(name))
]


@pytest.mark.parametrize("name, seed, width", _PALLAS_CASES)
def test_tile_kernel_matches_pallas(name, seed, width):
    rng = np.random.default_rng(100 * seed + int(name[1]))
    c = int(rng.choice([jrdk.CHUNK_SMALL, jrdk.CHUNK_BIG]))
    kk = int(rng.choice([1, 3, 6, 9]))
    tn = int(rng.choice([128, 256, 512]))
    if width is not None:
        c, tn = jrdk.CHUNK_SMALL, width
    mc, data = _tiles(rng, c, kk, tn, pad=bool(seed % 2))
    got = _run_port(name, mc, data)
    assert got.shape == (c, tn) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _run_jax(name, mc, data))


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_zero_padding_is_identity(name):
    """Zero K rows and zero tail bytes contribute nothing: the live
    prefix equals the unpadded product and the tail stays zero."""
    rng = np.random.default_rng(13)
    c, kk, tn, live_k, live_n = 4, 6, 128, 3, 100
    mc_live, live = _tiles(rng, c, live_k, live_n, pad=False)
    mc = np.zeros((c, kk, 8), dtype=np.uint8)
    mc[:, :live_k] = mc_live
    data = np.zeros((c, kk, tn), dtype=np.uint8)
    data[:, :live_k, :live_n] = live
    out = _run_port(name, mc, data)
    unpadded = np.zeros((c, live_k, 128), dtype=np.uint8)
    unpadded[:, :, :live_n] = live
    np.testing.assert_array_equal(out[:, :live_n], _run_port(name, mc_live, unpadded)[:, :live_n])
    assert not out[:, live_n:].any()
    np.testing.assert_array_equal(out, _run_jax(name, mc, data))


def test_contract_constants_identical():
    assert ragged_decode.CHUNK_SMALL == jrdk.CHUNK_SMALL == 4
    assert ragged_decode.CHUNK_BIG == jrdk.CHUNK_BIG == 32
    assert ragged_decode.DEFAULT_TILE_N == jrdk.DEFAULT_TILE_N == 4096
    assert ragged_encode.chunk_sizes is ragged_decode.chunk_sizes
    for n in (1, 3, 4, 5, 31, 32, 33, 101, 517, 4096):
        assert ragged_decode.chunk_sizes(n) == jrdk.chunk_sizes(n)
    for n in (1, 100, 128, 129, 4095, 4096, 70000):
        assert ops._next_pow2(n) == jops._next_pow2(n)


@pytest.mark.parametrize("seed", range(2))
def test_expand_coeff_bitplanes_identical(seed):
    coef = np.random.default_rng(seed).integers(0, 256, (5, 9), dtype=np.uint8)
    ours, theirs = expand_coeff_bitplanes(coef), np.asarray(jexpand(coef))
    assert ours.dtype == theirs.dtype and ours.shape == (5, 9, 8)
    np.testing.assert_array_equal(ours, theirs)


def test_wrappers_check_their_inputs():
    d = torch.zeros((4, 3, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        ragged_decode.ragged_xor_tiles(d.int())
    with pytest.raises(ValueError, match="mc must be"):
        ops.gf256_ragged(torch.zeros((4, 2, 8), dtype=torch.uint8), d)
    with pytest.raises(ValueError, match="empty"):
        ops.xor_ragged(torch.zeros((0, 3, 128), dtype=torch.uint8))


def test_plain_path_counts_no_launch():
    """The launch counters count CUDA launches only: CPU tensors take the
    plain version and leave them untouched."""
    _build.reset_launches()
    rng = np.random.default_rng(1)
    mc, data = _tiles(rng, 4, 3, 128, pad=False)
    for name in ENTRIES:
        _run_port(name, mc, data)
    assert set(_build.LAUNCHES) == {
        "ragged_gf256_tiles", "ragged_xor_tiles",
        "ragged_gf256_encode_tiles", "ragged_xor_encode_tiles",
        "gf256_matmul_planes", "gf256_matmul_planes_batched",
        "xor_parity", "xor_parity_batched", "selective_scan",
    }
    assert all(n == 0 for n in _build.LAUNCHES.values())


# ---------------------------------------------------------------------------
# coalescer: the port's ragged dataplane vs the JAX package's
# ---------------------------------------------------------------------------

def _random_window(rng, n_ops, lengths=(100, 512, 1000, 4096), encode=False):
    """Mixed window as in tests/test_ragged_decode.py: XOR ops over 3 or 5
    sources, GF ops with 1-3 targets over 6 sources, ragged lengths.
    Returns (port ops, JAX ops, store)."""
    xk, gk = ("EV", "EH") if encode else ("V", "H")
    ours, theirs, store = [], [], {}
    for i in range(n_ops):
        kind = [xk, gk][int(rng.integers(0, 2))]
        length = int(rng.choice(lengths))
        if kind == xk:
            kk = int(rng.choice([3, 5]))
            sources = tuple((f"g{i}", r, 0) for r in range(kk))
            args = (kind, f"g{i}", kk, (0,), sources, None)
        else:
            m = int(rng.integers(1, 4))
            sources = tuple((f"g{i}", 0, c) for c in range(6))
            coeffs = rng.integers(0, 256, (m, 6), dtype=np.uint8)
            args = (kind, f"g{i}", 0, tuple(range(m)), sources, coeffs)
        for s in sources:
            store[s] = rng.integers(0, 256, length, dtype=np.uint8)
        ours.append(DecodeOp(*args))
        theirs.append(JDecodeOp(*args))
    return ours, theirs, store


_MEASURED = {"compute_time", "encode_compute_time"}
# the port's own counter, which the reference's stats lack: held to the
# bytes of the decode outputs ``execute`` returned instead
_PORT_ONLY = {"decode_out_bytes"}


def _stats(co):
    return {
        f.name: getattr(co.stats, f.name)
        for f in dataclasses.fields(co.stats)
        if f.name not in _MEASURED | _PORT_ONLY
    }


def _units(units):
    return [(u.op_indices, u.kind, u.launch_id, u.fraction, u.tiles) for u in units]


def _assert_same_windows(windows, encode=False):
    """Run every window through both coalescers and compare everything
    but measured wall time."""
    ours = tco.DecodeCoalescer(device="cpu", autotune_kernels=False)
    theirs = jco.DecodeCoalescer(interpret=True, mode=jco.RAGGED, autotune_kernels=False)
    out_bytes = 0
    for w_ours, w_theirs, store in windows:
        fetch = lambda key: store[key]  # noqa: E731
        run_o = ours.execute_encode if encode else ours.execute
        run_t = theirs.execute_encode if encode else theirs.execute
        res_o, units_o = run_o(w_ours, fetch)
        res_t, units_t = run_t(w_theirs, fetch)
        if not encode:
            out_bytes += sum(a.nbytes for r in res_o for a in r.values())
        assert len(res_o) == len(res_t) == len(w_ours)
        for a, b in zip(res_o, res_t):
            assert set(a) == set(b)
            for col in a:
                np.testing.assert_array_equal(a[col], b[col])
        assert _units(units_o) == _units(units_t)
    assert _stats(ours) == _stats(theirs)
    assert ours.stats.decode_out_bytes == out_bytes
    assert ours.stats.padded_byte_ratio == theirs.stats.padded_byte_ratio
    assert ours.jit_entries_by_kind() == theirs.jit_entries_by_kind()
    return ours


@pytest.mark.parametrize("seed", range(5))
def test_coalescer_matches_jax_on_mixed_windows(seed):
    rng = np.random.default_rng(seed)
    _assert_same_windows([_random_window(rng, int(rng.integers(1, 16)))])


@pytest.mark.parametrize("seed", range(2))
def test_coalescer_encode_matches_jax_on_mixed_windows(seed):
    rng = np.random.default_rng(50 + seed)
    windows = [_random_window(rng, int(rng.integers(1, 12)), encode=True) for _ in range(2)]
    co = _assert_same_windows(windows, encode=True)
    assert co.stats.encode_calls > 0 and co.stats.decode_calls == 0


def test_coalescer_matches_jax_across_windows_and_cap_ratchets():
    """Several windows of growing size and length: the grow-only caps
    ratchet, signatures retire, and the counters still agree."""
    rng = np.random.default_rng(3)
    windows = [
        _random_window(rng, n, lengths=lengths)
        for n, lengths in ((1, (128,)), (3, (512,)), (9, (1000, 4096)), (40, (512, 4096)))
    ]
    co = _assert_same_windows(windows)
    assert all(n <= 2 for n in co.jit_entries_by_kind().values())
    assert co.stats.jit_retraces > co.stats.jit_entries


def test_coalescer_overflow_and_multi_tile_rows_match_jax():
    """A window of many small XOR ops (several big chunks plus small
    ones) and one row spanning several tiles with a ragged tail."""
    rng = np.random.default_rng(99)
    ours, theirs, store = [], [], {}
    for i in range(266):
        sources = tuple((f"g{i}", r, 0) for r in range(3))
        for s in sources:
            store[s] = rng.integers(0, 256, 64, dtype=np.uint8)
        ours.append(DecodeOp("V", f"g{i}", 3, (0,), sources, None))
        theirs.append(JDecodeOp("V", f"g{i}", 3, (0,), sources, None))
    long_src = tuple(("big", r, 0) for r in range(3))
    store2 = {s: rng.integers(0, 256, 10_000, dtype=np.uint8) for s in long_src}
    long_op = ("V", "big", 3, (0,), long_src, None)
    co = _assert_same_windows(
        [(ours, theirs, store), ([DecodeOp(*long_op)], [JDecodeOp(*long_op)], store2)]
    )
    assert co.stats.decode_calls == len(ragged_decode.chunk_sizes(266)) + len(
        ragged_decode.chunk_sizes(-(-10_000 // ragged_decode.DEFAULT_TILE_N))
    )


def test_modes_and_autotune_construct():
    """Both dataplanes and the autotuner are ported: every combination
    constructs, autotuning is the default as in the JAX package, and an
    unknown mode is still refused."""
    for mode in (tco.RAGGED, tco.BUCKETED):
        for tune in (False, True):
            co = tco.DecodeCoalescer(device="cpu", mode=mode, autotune_kernels=tune)
            assert (co.mode, co.autotune_kernels) == (mode, tune)
    assert tco.DecodeCoalescer(device="cpu").autotune_kernels is True
    with pytest.raises(ValueError):
        tco.DecodeCoalescer(device="cpu", mode="mega")
