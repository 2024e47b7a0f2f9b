"""The port's measured autotuning (kernels/autotune.py), twin of
tests/test_autotune.py: the sweep picks a real candidate and caches it per
device — in process AND on disk, so winners survive across processes —
and the port shares the reference package's cache file without ever
overwriting its entries. On the CPU the sweep times the kernels' plain
versions; every candidate it can pick must agree with the JAX package
bit for bit."""

import json

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import autotune, ops  # noqa: E402


@pytest.fixture
def disk_cache(tmp_path, monkeypatch):
    """Isolated disk cache + empty in-process caches (both packages)."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    saved = dict(autotune._CACHE), dict(jautotune._CACHE)
    autotune._CACHE.clear()
    jautotune._CACHE.clear()
    yield path
    for cache, old in zip((autotune._CACHE, jautotune._CACHE), saved):
        cache.clear()
        cache.update(old)


@pytest.mark.parametrize(
    "tune,kind,cands",
    [
        (autotune.tuned_gf256, "gf256", autotune.GF_BLOCK_CANDIDATES),
        (autotune.tuned_xor, "xor", autotune.XOR_BLOCK_CANDIDATES),
        (autotune.tuned_ragged_gf256, "ragged_gf256", autotune.RAGGED_GF_TILE_CANDIDATES),
        (autotune.tuned_ragged_xor, "ragged_xor", autotune.RAGGED_XOR_TILE_CANDIDATES),
    ],
)
def test_tuner_picks_candidate_and_caches(disk_cache, tune, kind, cands):
    before = autotune.cache_stats()
    tuned = tune("cpu")
    assert tuned.block_n in cands["cpu"]
    assert tuned.packed is False  # one body per kernel: packed selects nothing
    assert tuned.elapsed > 0
    assert tune("cpu") is tuned  # process-lifetime cache
    after = autotune.cache_stats()
    assert after["sweeps"] == before["sweeps"] + 1
    assert after["memory_hits"] == before["memory_hits"] + 1
    key = f"cpu/{kind}/plain"
    assert key in autotune.report()
    assert set(autotune.sweep_times()[key]) == set(cands["cpu"])


def test_candidate_sets_and_disk_keys():
    """The CPU sets mirror the reference's; the card's keys never
    collide with the reference's ``<backend>/<kind>/<variant>``."""
    assert autotune.GF_BLOCK_CANDIDATES["cpu"] == jautotune.GF_BLOCK_CANDIDATES
    assert autotune.XOR_BLOCK_CANDIDATES["cpu"] == jautotune.XOR_BLOCK_CANDIDATES
    assert autotune.RAGGED_GF_TILE_CANDIDATES["cpu"] == jautotune.RAGGED_GF_TILE_CANDIDATES
    assert autotune.RAGGED_XOR_TILE_CANDIDATES["cpu"] == jautotune.RAGGED_XOR_TILE_CANDIDATES
    assert autotune._disk_key("gf256", "cuda") == "cuda/gf256/kernel"
    assert autotune._disk_key("xor", "cpu") == "cpu/xor/plain"
    theirs = {jautotune._disk_key(k, i) for k in ("gf256", "xor") for i in (False, True)}
    ours = {autotune._disk_key(k, d) for k in ("gf256", "xor") for d in ("cpu", "cuda")}
    assert not theirs & ours
    for cands in (autotune.GF_BLOCK_CANDIDATES, autotune.XOR_BLOCK_CANDIDATES):
        assert all(bn % 16 == 0 for bn in cands["cuda"])  # whole uint4 vectors
        assert autotune._CUDA_PROBE_BYTES % max(cands["cuda"]) == 0


def test_block_n_capped_to_payload_size():
    t = autotune.TunedKernel(block_n=32768, packed=False, elapsed=0.0)
    for n in (1000, 128, 50, 1 << 20):
        assert t.block_n_for(n) == jautotune.TunedKernel(32768, False, 0.0).block_n_for(n)
    assert t.block_n_for(1000) == 1024
    assert t.block_n_for(50) == 128  # kernel minimum tile
    assert t.block_n_for(1 << 20) == 32768  # never above the tuned value


def test_sweep_persists_winner_to_disk(disk_cache):
    tuned = autotune.tuned_xor("cpu")
    doc = json.loads(disk_cache.read_text())
    entry = doc["entries"]["cpu/xor/plain"]
    assert (entry["block_n"], entry["packed"]) == (tuned.block_n, tuned.packed)


def test_persisted_winner_loads_without_sweeping(disk_cache, monkeypatch):
    autotune.tuned_xor("cpu")
    autotune._CACHE.clear()  # a new process

    def boom(*a, **kw):
        raise AssertionError("sweep ran despite a persisted winner")

    monkeypatch.setattr(autotune, "_best", boom)
    hits = autotune.cache_stats()["disk_hits"]
    assert autotune.tuned_xor("cpu").block_n in autotune.XOR_BLOCK_CANDIDATES["cpu"]
    assert autotune.cache_stats()["disk_hits"] == hits + 1


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_stale_disk_entry_is_ignored(disk_cache, device):
    """A winner outside the current candidate set (a retired
    configuration) is not loaded, for the card's keys as for the CPU's."""
    key = autotune._disk_key("xor", device)
    disk_cache.write_text(json.dumps({
        "schema": 1,
        "entries": {key: {"block_n": 12345, "packed": False, "elapsed": 0.001}},
    }))
    cands = autotune.XOR_BLOCK_CANDIDATES[device]
    assert autotune._load_persisted("xor", device, cands) is None
    good = dict(block_n=cands[0], packed=False, elapsed=0.5)
    disk_cache.write_text(json.dumps({"schema": 1, "entries": {key: good}}))
    assert autotune._load_persisted("xor", device, cands) == autotune.TunedKernel(**good)
    if device == "cpu":
        disk_cache.write_text(json.dumps({
            "schema": 1,
            "entries": {key: {"block_n": 12345, "packed": False, "elapsed": 0.001}},
        }))
        assert autotune.tuned_xor("cpu").block_n in cands


def test_clear_cache_clears_disk_too(disk_cache):
    autotune.tuned_xor("cpu")
    assert disk_cache.exists()
    autotune.clear_cache()
    assert not disk_cache.exists()
    assert autotune.report() == {}


def test_cache_disabled_via_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "off")
    assert autotune.cache_path() is None
    saved = dict(autotune._CACHE)
    autotune._CACHE.clear()
    try:
        autotune.tuned_xor("cpu")  # must not raise without a disk path
    finally:
        autotune._CACHE.clear()
        autotune._CACHE.update(saved)
    assert not (tmp_path / "autotune.json").exists()


@pytest.mark.parametrize("garbage", ["{not json", "[1, 2]", '{"entries": 7}'])
def test_corrupt_disk_cache_is_nonfatal(disk_cache, garbage):
    disk_cache.write_text(garbage)
    assert autotune.tuned_xor("cpu").block_n in autotune.XOR_BLOCK_CANDIDATES["cpu"]
    assert "cpu/xor/plain" in json.loads(disk_cache.read_text())["entries"]


def test_reference_and_port_entries_share_one_file(disk_cache):
    """A reference entry survives a port write, and the reverse: both
    read-merge-write the same file under keys that never collide."""
    jautotune.tuned_xor(True)
    autotune.tuned_xor("cpu")
    entries = json.loads(disk_cache.read_text())["entries"]
    assert {jautotune._disk_key("xor", True), "cpu/xor/plain"} <= set(entries)
    autotune._CACHE.clear()
    jautotune._CACHE.clear()
    autotune.tuned_gf256("cpu")
    jautotune.tuned_gf256(True)
    entries = json.loads(disk_cache.read_text())["entries"]
    assert {
        jautotune._disk_key("xor", True), jautotune._disk_key("gf256", True),
        "cpu/xor/plain", "cpu/gf256/plain",
    } <= set(entries)
    # each package reads its own winner back
    autotune._CACHE.clear()
    jautotune._CACHE.clear()
    assert autotune.tuned_gf256("cpu").block_n == entries["cpu/gf256/plain"]["block_n"]
    want = entries[jautotune._disk_key("gf256", True)]["block_n"]
    assert jautotune.tuned_gf256(True).block_n == want


@pytest.mark.parametrize("block_n", sorted({
    *autotune.GF_BLOCK_CANDIDATES["cpu"], *autotune.GF_BLOCK_CANDIDATES["cuda"]}))
def test_every_gf256_candidate_config_matches_jax(block_n):
    """Whatever a sweep picks, on the card or the CPU, gives the JAX
    package's bytes."""
    rng = np.random.default_rng(block_n)
    b, m, k, n = 3, 2, 6, 4096
    coefs = rng.integers(0, 256, size=(b, m, k), dtype=np.uint8)
    data = rng.integers(0, 256, size=(b, k, n), dtype=np.uint8)
    bn = min(block_n, n)
    got = ops.gf256_matmul_batched(coefs, torch.from_numpy(data), block_n=bn).numpy()
    want = jops.gf256_matmul_batched(coefs, jnp.asarray(data), block_n=bn, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
