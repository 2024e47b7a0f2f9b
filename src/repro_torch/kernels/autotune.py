"""Measured autotuning for the GF(256) / XOR kernel entries.

The kernels expose a knob whose best setting depends on where they run:

  * ``block_n`` — the bytes one thread block of the K5/K6/K7 CUDA bodies
    covers (and the padding unit of ops.py). Narrow blocks mean more
    blocks in flight and less tail padding; wide ones amortise each
    block's plane staging over more bytes.
  * the ragged tile kernels' TILE WIDTH (kernels/ragged_decode.py) — the
    launch-count-vs-padding trade-off per descriptor tile: fat tiles
    mean fewer launches and host copies, narrow tiles less tail filler
    on short rows.
  * ``packed`` is kept in every record for the reference's format. The
    port has one body per kernel (the u32 mask-spread algebra), so the
    sweep measures block widths only and ``packed`` is always False.

Instead of hard-coding defaults, this module *measures* the candidates
once per (kernel, device) at first use — on the card the CUDA kernels,
timed with ``torch.cuda.synchronize`` around each probe; on the CPU their
plain torch versions, so the sweep itself is exercised by the CPU tests
— and caches the winner for the process lifetime. The gateway's decode
coalescer asks for tuned parameters before its first launch; everything
stays off the request path because results are cached.

Winners also persist ACROSS processes: an atomic JSON cache lives at
``default_cache_path()`` — override with ``set_cache_path()`` or the
``REPRO_AUTOTUNE_CACHE`` env var (set it to ``off`` to disable
persistence) — and is consulted before any sweep runs. The file is the
reference package's: the port's entries are keyed ``cuda/<kind>/kernel``
and ``cpu/<kind>/plain``, which never collide with the reference's
``<backend>/<kind>/interpret|compiled``, and every write merges into the
entries already there. Entries whose ``block_n`` no longer matches the
current candidate set are ignored (a stale cache must not pin a retired
configuration), and ``clear_cache()`` drops the disk file along with the
in-process winners.

The CPU probe shapes mirror the reference's and are tiny: the point is
ranking the candidates, not absolute numbers. On the card a probe that
small times launch latency alone, so the GF/XOR probes there cover
``_CUDA_PROBE_BYTES`` per row, and the ragged probe's rows are
``_CUDA_RAGGED_PROBE_ROW_BYTES`` long: with 64 KiB rows an 8 KiB and a
64 KiB tile both fill one chunk, tie on launch count, and noise picks
between them, while the serve's 64 MiB rows take eight times as many
chunks at 8 KiB. Callers cap ``block_n`` to their actual
byte length (ops.py pads N up to a block_n multiple, so a tuned 32 KiB
tile applied to 4 KiB blocks would 8x the work).
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.backend import resolve_device, synchronize
from repro_torch.kernels.ragged_decode import chunk_sizes

# Candidate sets per device type. The CPU's mirror the reference's. The
# card's come from chip_smoke.py phase 2's block_n sweep of K5-K7 at the
# bucketed serve's 64 MiB blocks (H100 SXM, 700 W; PERF.md keeps the
# numbers): every width from 1 to 16 KiB ran within 4% of the best, and
# 64 KiB and wider fell 5-32% behind, so the GF and XOR sets span the
# flat region and let the probe pick. The ragged sets keep the fixed
# default tile (4 KiB) beside wider ones: fat tiles mean fewer launches
# and host copies, which is what the card's probe window ranks.
GF_BLOCK_CANDIDATES = {
    "cpu": (2048, 8192, 32768),
    "cuda": (2048, 4096, 8192, 16384),
}
XOR_BLOCK_CANDIDATES = {
    "cpu": (8192, 65536),
    "cuda": (1024, 2048, 4096, 8192),
}
# Ragged tile kernels' tile widths (bytes per descriptor tile).
RAGGED_GF_TILE_CANDIDATES = {
    "cpu": (1024, 4096, 16384, 65536),
    "cuda": (4096, 8192, 16384, 65536),
}
RAGGED_XOR_TILE_CANDIDATES = {
    "cpu": (4096, 65536),
    "cuda": (4096, 16384, 65536),
}
_PROBE_REPEATS = 3
# bytes per probe row for the GF / XOR sweeps on the card (a multiple of
# every CUDA candidate)
_CUDA_PROBE_BYTES = 1 << 24

_CACHE_ENV = "REPRO_AUTOTUNE_CACHE"


@dataclass(frozen=True)
class TunedKernel:
    block_n: int
    packed: bool
    elapsed: float  # best measured seconds for the winning config

    def block_n_for(self, n: int) -> int:
        """Tuned tile capped to the actual byte length (ops' next-power-
        of-two rounding), so padding never multiplies the work."""
        return min(self.block_n, ops._next_pow2(n))


_CACHE: dict[tuple[str, str], TunedKernel] = {}
_cache_path_override: pathlib.Path | None = None
_cache_path_set = False

# Where tuned parameters came from, for first-class observability:
# process-cache hits, disk-cache hits, and fresh sweeps run.
_STATS = {"memory_hits": 0, "disk_hits": 0, "sweeps": 0}
# Every candidate's best probe time of every sweep this process ran,
# keyed like the disk cache: {key: {block_n: seconds}}.
_SWEEPS: dict[str, dict[int, float]] = {}


def cache_stats() -> dict[str, int]:
    """Cumulative autotune cache accounting for this process: how many
    ``_tuned`` lookups were served from the in-process cache, how many
    from the persisted disk cache, and how many ran a fresh sweep."""
    return dict(_STATS)


def sweep_times() -> dict[str, dict[int, float]]:
    """Each sweep's probe time per candidate (best of the repeats, in
    seconds), keyed ``<device>/<kind>/<variant>``."""
    return {key: dict(times) for key, times in _SWEEPS.items()}


def default_cache_path() -> pathlib.Path:
    return pathlib.Path.home() / ".cache" / "repro" / "autotune.json"


def cache_path() -> pathlib.Path | None:
    """Active disk-cache location: explicit set_cache_path() wins, then
    the REPRO_AUTOTUNE_CACHE env var (value "off"/"0"/"" disables), then
    the per-user default."""
    if _cache_path_set:
        return _cache_path_override
    env = os.environ.get(_CACHE_ENV)
    if env is not None:
        if env.strip().lower() in ("", "0", "off", "none"):
            return None
        return pathlib.Path(env)
    return default_cache_path()


def set_cache_path(path: str | os.PathLike | None) -> None:
    """Pin the disk cache to ``path`` (None disables persistence)."""
    global _cache_path_override, _cache_path_set
    _cache_path_override = pathlib.Path(path) if path is not None else None
    _cache_path_set = True


def _disk_key(kind: str, device_type: str) -> str:
    variant = "kernel" if device_type == "cuda" else "plain"
    return f"{device_type}/{kind}/{variant}"


def _load_disk() -> dict[str, dict]:
    path = cache_path()
    if path is None:
        return {}
    try:
        with open(path) as f:
            doc = json.load(f)
        entries = doc.get("entries", {})
        return entries if isinstance(entries, dict) else {}
    except (OSError, ValueError, AttributeError):
        return {}


def _save_disk(kind: str, device_type: str, tuned: TunedKernel) -> None:
    """Atomic read-merge-write (tmp file + os.replace) so concurrent
    sweeps never tear the JSON and entries of other keys (the reference
    package's among them) survive; persistence failures are non-fatal."""
    path = cache_path()
    if path is None:
        return
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        entries = _load_disk()
        entries[_disk_key(kind, device_type)] = {
            "block_n": tuned.block_n,
            "packed": tuned.packed,
            "elapsed": tuned.elapsed,
        }
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"schema": 1, "entries": entries}, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except BaseException:
            # never leave a stray .tmp next to the cache
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError:
        pass


def _load_persisted(
    kind: str, device_type: str, candidates: tuple[int, ...]
) -> TunedKernel | None:
    entry = _load_disk().get(_disk_key(kind, device_type))
    if not isinstance(entry, dict):
        return None
    try:
        block_n, packed = int(entry["block_n"]), bool(entry["packed"])
        elapsed = float(entry.get("elapsed", 0.0))
    except (KeyError, TypeError, ValueError):
        return None
    if block_n not in candidates:
        return None  # stale entry from a retired candidate set
    return TunedKernel(block_n=block_n, packed=packed, elapsed=elapsed)


def clear_cache() -> None:
    """Drop the in-process winners AND the persisted disk cache."""
    _CACHE.clear()
    path = cache_path()
    if path is not None:
        try:
            path.unlink()
        except OSError:
            pass


def report() -> dict[str, dict]:
    """Tuned winners so far, keyed like the disk cache
    (``<device>/<kind>/<variant>``), for benchmark rows."""
    return {
        _disk_key(kind, device_type): {
            "block_n": t.block_n,
            "packed": t.packed,
            "elapsed": t.elapsed,
        }
        for (kind, device_type), t in _CACHE.items()
    }


def _best(candidates: list, device: torch.device, key: str) -> tuple[int, bool, float]:
    """Time each ``(block_n, launch)`` probe (untimed warm-up, then the
    best of ``_PROBE_REPEATS``, each bracketed by a device synchronize)
    and return the fastest candidate."""
    best_bn, best_dt = None, float("inf")
    times = _SWEEPS.setdefault(key, {})
    for bn, launch in candidates:
        launch()  # untimed warm-up: first launch, allocator growth
        synchronize(device)
        dt = float("inf")
        for _ in range(_PROBE_REPEATS):
            synchronize(device)
            t0 = time.perf_counter()
            launch()
            synchronize(device)
            dt = min(dt, time.perf_counter() - t0)
        times[bn] = dt
        if dt < best_dt:
            best_bn, best_dt = bn, dt
    return best_bn, False, best_dt


def _tuned(kind: str, device: torch.device, candidates: tuple[int, ...], sweep) -> TunedKernel:
    """Shared memoization spine: process cache -> disk cache -> sweep."""
    cached = _CACHE.get((kind, device.type))
    if cached is not None:
        _STATS["memory_hits"] += 1
        return cached
    tuned = _load_persisted(kind, device.type, candidates)
    if tuned is None:
        bn, packed, dt = _best(sweep(), device, _disk_key(kind, device.type))
        tuned = TunedKernel(block_n=bn, packed=packed, elapsed=dt)
        _save_disk(kind, device.type, tuned)
        _STATS["sweeps"] += 1
    else:
        _STATS["disk_hits"] += 1
    _CACHE[(kind, device.type)] = tuned
    return tuned


def _random(rng, shape, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(device)


def _probe_bytes(device: torch.device, candidates: tuple[int, ...]) -> int:
    return _CUDA_PROBE_BYTES if device.type == "cuda" else max(candidates)


def tuned_gf256(device: str | torch.device | None = None) -> TunedKernel:
    """Winning block_n for the batched GF(256) decode entry (K6)."""
    device = resolve_device(device)
    cands = GF_BLOCK_CANDIDATES[device.type]

    def sweep():
        n = _probe_bytes(device, cands)  # multiple of every candidate
        rng = np.random.default_rng(0)
        coefs = rng.integers(0, 256, size=(2, 2, 6), dtype=np.uint8)
        data = _random(rng, (2, 6, n), device)
        return [
            (bn, lambda bn=bn: ops.gf256_matmul_batched(coefs, data, block_n=bn))
            for bn in cands
        ]

    return _tuned("gf256", device, cands, sweep)


def tuned_xor(device: str | torch.device | None = None) -> TunedKernel:
    """Winning block_n for the batched XOR parity entry (K7)."""
    device = resolve_device(device)
    cands = XOR_BLOCK_CANDIDATES[device.type]

    def sweep():
        n = _probe_bytes(device, cands)
        rng = np.random.default_rng(1)
        data = _random(rng, (2, 3, n), device)
        return [(bn, lambda bn=bn: ops.xor_parity_batched(data, block_n=bn)) for bn in cands]

    return _tuned("xor", device, cands, sweep)


# The ragged tile-width probe stages a fixed WINDOW — a few rows of a
# fixed byte length — exactly as the coalescer would: rows cut into
# ceil(L / tn) tiles (tail padding included), tiles covered by the
# small/big chunk rungs, ONE launch per chunk. Ranking any other way is
# blind to the knob's real trade-off: fat tiles mean fewer launches,
# narrow tiles less tail filler — per-launch bytes alone are constant
# across candidates.
_RAGGED_PROBE_ROWS = 4
_RAGGED_PROBE_ROW_BYTES = 65536
_CUDA_RAGGED_PROBE_ROW_BYTES = 1 << 20


def _ragged_probe_chunks(kk: int, tn: int, rng, device: torch.device) -> tuple[list[int], dict]:
    row_bytes = (
        _CUDA_RAGGED_PROBE_ROW_BYTES if device.type == "cuda" else _RAGGED_PROBE_ROW_BYTES
    )
    tiles_per_row = -(-row_bytes // tn)
    chunks = chunk_sizes(_RAGGED_PROBE_ROWS * tiles_per_row)
    bufs = {
        c: (_random(rng, (c, kk, 8), device), _random(rng, (c, kk, tn), device))
        for c in sorted(set(chunks))
    }
    return chunks, bufs


def tuned_ragged_gf256(device: str | torch.device | None = None) -> TunedKernel:
    """Winning tile width for the ragged GF(256) tile kernel (``block_n``
    is the descriptor tile width TN)."""
    device = resolve_device(device)
    cands = RAGGED_GF_TILE_CANDIDATES[device.type]

    def sweep():
        rng = np.random.default_rng(2)
        out = []
        for tn in cands:
            chunks, bufs = _ragged_probe_chunks(6, tn, rng, device)
            out.append((tn, lambda chunks=chunks, bufs=bufs: [
                ops.gf256_ragged(*bufs[c]) for c in chunks
            ]))
        return out

    return _tuned("ragged_gf256", device, cands, sweep)


def tuned_ragged_xor(device: str | torch.device | None = None) -> TunedKernel:
    """Winning tile width for the ragged XOR tile kernel."""
    device = resolve_device(device)
    cands = RAGGED_XOR_TILE_CANDIDATES[device.type]

    def sweep():
        rng = np.random.default_rng(3)
        out = []
        for tn in cands:
            chunks, bufs = _ragged_probe_chunks(3, tn, rng, device)
            out.append((tn, lambda chunks=chunks, bufs=bufs: [
                ops.xor_ragged(bufs[c][1]) for c in chunks
            ]))
        return out

    return _tuned("ragged_xor", device, cands, sweep)
