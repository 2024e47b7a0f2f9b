"""The port's crc32 (``repro_torch/storage/crc32.py``, the carry-less-
multiply fold of ``csrc/crc32_fold.c``) against ``zlib.crc32``, the
integer the JAX package's ``BlockStore.digest`` gives: the C entry at
each of its bodies, ``BlockStore.digest`` of both packages, chained
seeds, misaligned starts, copies of non-contiguous arrays and the pooled
``crc32_many``; then the fallback to zlib where the library is missing or
the CPU lacks the instructions, and the ``host_crc32_bytes`` counter."""

from __future__ import annotations

import importlib
import zlib

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.storage import blockstore as bs  # noqa: E402
from repro_torch.storage import crc32  # noqa: E402

REF = importlib.import_module("repro.storage.blockstore")

BUF = np.random.default_rng(31).integers(0, 256, (1 << 20) + 64, dtype=np.uint8)
LENGTHS = {
    "0-256": range(257),
    "4KiB": (4095, 4096, 4097),
    "64KiB": (65535, 65536, 65537),
    "1MiB": ((1 << 20) - 1, 1 << 20, (1 << 20) + 1),
}
SEEDS = (0, 1, 0xFFFFFFFF, 0x9E3779B9)


@pytest.fixture(scope="module")
def lib():
    if crc32.find_cc() is None:
        pytest.skip("no C compiler on this host: the fold cannot be built here")
    loaded = crc32.library()
    assert loaded is not None, crc32.build_error
    return loaded


def fold_at(lib, level, view, crc=0):
    return lib.crc32_fold_at(level, view.ctypes.data, view.nbytes, crc)


@pytest.mark.parametrize("level", [0, 1, 2], ids=["table", "lanes128", "lanes512"])
@pytest.mark.parametrize("lengths", LENGTHS)
def test_each_body_equals_zlib(lib, lengths, level):
    """A level above this CPU's best runs at its best: every case holds
    the integer either way."""
    for n in LENGTHS[lengths]:
        view = BUF[:n]
        for seed in SEEDS:
            assert fold_at(lib, level, view, seed) == zlib.crc32(view, seed), (n, seed)


@pytest.mark.parametrize("lengths", LENGTHS)
def test_digest_of_both_packages_equals_zlib(lib, lengths):
    for n in LENGTHS[lengths]:
        view = BUF[:n]
        want = zlib.crc32(view)
        assert lib.crc32_fold(view.ctypes.data, n, 0) == want, n
        assert bs.BlockStore.digest(view) == want, n
        assert REF.BlockStore.digest(view) == want, n


def test_a_seeded_64mib_block(lib):
    block = np.random.default_rng(2**31 + 31).integers(0, 256, 64 << 20, dtype=np.uint8)
    want = zlib.crc32(block)
    assert lib.crc32_fold(block.ctypes.data, block.nbytes, 0) == want
    assert bs.BlockStore.digest(block.reshape(1024, -1)) == want
    assert REF.BlockStore.digest(block) == want


@pytest.mark.parametrize("offset", range(1, 16))
def test_misaligned_starts(lib, offset):
    for n in (63, 64, 255, 256, 257, 8192 + 17, 65536 + 5):
        view = BUF[offset:offset + n]
        want = zlib.crc32(view)
        assert view.ctypes.data % 16 == offset % 16
        for level in (0, 1, 2):
            assert fold_at(lib, level, view) == want, (n, level)
        assert bs.BlockStore.digest(view) == want, n


_BYTES = np.random.default_rng(5).integers(0, 256, 1 << 16, dtype=np.uint8)
# DIGEST_CASES of tests/test_torch_integrity.py at sizes the fold takes
DIGEST_CASES = {
    "uint8_1d": _BYTES,
    "block_2d": _BYTES.reshape(256, 256),
    "strided": _BYTES.reshape(256, 256)[::3, 1::2],
    "float32": _BYTES.view(np.float32).reshape(128, 128).T,
    "empty": _BYTES[:0],
}


@pytest.mark.parametrize("case", DIGEST_CASES)
def test_digest_of_an_array_equals_zlib_of_its_bytes(lib, case):
    a = DIGEST_CASES[case]
    want = zlib.crc32(np.asarray(a).tobytes())
    assert (bs._as_bytes(a).nbytes >= crc32.FOLD_MIN_BYTES) == (case != "empty")
    assert bs.BlockStore.digest(a) == want
    assert REF.BlockStore.digest(a) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_a_seed_chains_over_two_halves(lib, seed):
    for n in (100, 8192, 65537, 1 << 20):
        whole = BUF[:n]
        half = n // 2
        for level in (0, 1, 2):
            first = fold_at(lib, level, whole[:half], seed)
            assert fold_at(lib, level, whole[half:], first) == zlib.crc32(whole, seed), (n, level)


@pytest.mark.parametrize("cpus", [1, 4])
def test_crc32_many_equals_a_serial_loop(lib, monkeypatch, cpus):
    monkeypatch.setattr(bs, "_cpus", lambda: cpus)
    rng = np.random.default_rng(cpus)
    arrays = [rng.integers(0, 256, n, dtype=np.uint8) for n in
              (0, 7, 8191, 8192, 300_000, 1 << 20, (1 << 20) + 3, 4096, 65536)]
    arrays.append(arrays[5].reshape(1024, 1024)[:, ::2])
    assert sum(a.nbytes for a in arrays) >= bs.POOL_MIN_BYTES
    assert bs.crc32_many(arrays) == [bs.BlockStore.digest(a) for a in arrays] == [
        zlib.crc32(np.asarray(a).tobytes()) for a in arrays]


def _store():
    store = bs.BlockStore(num_nodes=30)
    store.put_group("g0", np.random.default_rng(11).integers(0, 256, (2, 5, 1 << 16),
                                                             dtype=np.uint8))
    store.corrupt_block(("g0", 0, 1), mode="bitflip")
    store.corrupt_block(("g0", 1, 3), mode="torn")
    return store


def _answers(store):
    keys = sorted(store.blocks)
    data = store.blocks[("g0", 1, 2)]
    return (store.verify_many(keys), [store.verify(k) for k in keys],
            store.checksum_ok(("g0", 1, 2), data), store.checksum_ok(("g0", 0, 1), data),
            [store.digest(store.blocks[k]) for k in keys])


@pytest.mark.parametrize("how", ["no_library", "no_fast_path"])
def test_without_the_fold_every_answer_is_the_same(lib, monkeypatch, how):
    store = _store()
    with_fold = _answers(store)
    assert crc32.fold() is not None
    if how == "no_library":
        monkeypatch.setattr(crc32, "library", lambda: None)
    else:
        monkeypatch.setattr(crc32, "fast_path", lambda: False)
    assert crc32.fold() is None
    assert _answers(store) == with_fold
    assert with_fold[0] == [("g0", 0, 1), ("g0", 1, 3)]


@pytest.mark.parametrize("impl", ["fold", "zlib"])
@pytest.mark.parametrize("entry", ["digest", "crc32_many"])
def test_host_crc32_bytes_counts_the_bytes_by_path(lib, monkeypatch, entry, impl):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import MetricsRegistry, host

    monkeypatch.setattr(bs, "_cpus", lambda: 4)
    if impl == "zlib":
        monkeypatch.setattr(crc32, "fast_path", lambda: False)
    sizes = (0, 100, 8191, 8192, 65536, (1 << 20) + 1)
    arrays = [BUF[:n] for n in sizes]
    reg = MetricsRegistry()
    with profile(activities=[ProfilerActivity.CPU]), host.recording(reg, "test.root"):
        if entry == "digest":
            got = [bs.BlockStore.digest(a) for a in arrays]
        else:
            got = bs.crc32_many(arrays)
    assert got == [zlib.crc32(a) for a in arrays]
    big = sum(n for n in sizes if n >= crc32.FOLD_MIN_BYTES)
    folded = big if impl == "fold" else 0
    assert reg.counter_total("host_crc32_bytes", impl="fold") == folded
    assert reg.counter_total("host_crc32_bytes", impl="zlib") == sum(sizes) - folded
    quiet = MetricsRegistry()
    with host.recording(quiet, "test.root"):  # no profiler running: nothing recorded
        bs.crc32_many(arrays)
    assert quiet.counter_total("host_crc32_bytes") == 0
