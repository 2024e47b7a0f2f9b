"""Request coalescer: execute a window's degraded-read decodes in as few
kernel launches as the shape mix allows.

Two dataplanes share one interface (``DecodeCoalescer(mode=...)``):

**Ragged tile dataplane (default, ``mode="ragged"``).** A realistic
mixed-tenant window holds decodes of MIXED shapes — horizontal RS ops
with varying target counts, vertical XOR repairs, ragged byte lengths.
The ragged path stages the WHOLE window per kind: every decode row (one
output row of one op) is cut into fixed-width tiles (width autotuned,
capped to the longest row), gathered into a preallocated staging buffer
``(C, K, TN)`` with per-tile coefficient bit-planes, and decoded by ONE
tile-kernel launch per chunk whose grid walks tiles
(kernels/ragged_decode.py, CUDA C++ in kernels/csrc/ragged_tiles.cu).
Flattening to ROWS is what removes the target count M from the launch
shape; its price is that an op with M targets stages its K source slabs
once per target row — accepted because M > 1 is the rare case
(multi-loss rows). The launch tile count C comes from exactly two rungs
(small/big chunk), so the LIVE launch signatures per kind stay <= 2 no
matter how diverse the traffic — ``jit_entries`` counts them, under the
reference package's name — and ``padded_ops`` is 0 by construction: the
only filler is tail tiles and the final chunk's null tiles, reported as
``stats.padded_byte_ratio``. The K axis and tile width are grow-only
caps: a window exceeding a cap starts a new signature and retires the
outgrown ones; cumulative churn stays visible as ``stats.jit_retraces``.
The counters equal the reference package's on the same traffic.

Staging-buffer contract: one flat buffer per (kind, C) holds the chunk's
``(C, K, TN)`` data tiles followed by its ``(C, K, 8)`` bit-planes, is
preallocated once (pinned when the device is the card) and reused across
windows, and crosses to the device in ONE blocking host-to-device copy
per chunk (blocking, because the buffer is refilled for the next chunk).
The gather writes each source's bytes straight into its tile slab,
zero-filling K-axis padding and tile tails — zero bytes are the identity
for both GF(256) products and XOR, so the kernel needs no masking and
the host slices each row's valid prefix back out.

**Shape buckets (``mode="bucketed"``, the baseline).** One stacked
launch per (kind, M, K, blocklen) bucket — "H" decodes through
``ops.gf256_matmul_batched`` (K6), "V" repairs through
``ops.xor_parity_batched`` (K7) — batch sizes padded up a fixed
power-of-two ladder (PAD_LADDER) by replicating the first stripe,
buckets beyond the top rung split into top-rung chunks. A bucket's
stripes are gathered straight into one ``(B_pad, K, N)`` host array,
copied to the device, decoded, and copied back. Encode kinds ("EH",
"EV") stay ragged in both modes.

Engine-pool integration: ``execute`` returns a list of ``LaunchUnit``s
— the simulated-compute quanta the gateway dispatches onto its parallel
decode engines. A bucketed launch is one unit owning its batch; a tile
launch is SPLIT by tile ranges into one unit per op, each billed its
tile share of the measured launch time, so one physical launch can still
spread across engines. The gateway gates every unit of a launch on the
launch-wide source barrier (the staging buffer holds all its ops'
tiles), keyed by ``launch_id``.

Compute time is measured on the real kernels (host clock around the
host-to-device copy, the launch, a device synchronize and the copy
back) and scaled by the cluster profile, mirroring BlockFixer's
convention. Each launch signature is billed at its BEST-observed
execution time: the kernel's intrinsic cost is its fastest run, and
transient host stalls (a noisy neighbour during one launch) are not
properties of the simulated hardware — without the floor, one slow
wall-clock sample would skew a whole simulated-latency distribution.
"""

from __future__ import annotations

import bisect
import logging
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.gateway.planner import DecodeOp
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import ragged_decode as _rdk
from repro_torch.kernels.backend import resolve_device, synchronize
from repro_torch.kernels.gf256_matmul import expand_coeff_bitplanes
from repro_torch.kernels.ops import _next_pow2
from repro_torch.obs import host
from repro_torch.storage.blockstore import BlockKey

_log = logging.getLogger(__name__)

RAGGED = "ragged"
BUCKETED = "bucketed"

# Batch-size rungs for the bucketed baseline: B pads up to the next rung
# (powers of two). Buckets larger than the top rung are SPLIT into
# top-rung launches, so the distinct launch signatures per decode shape
# are truly <= len(PAD_LADDER).
PAD_LADDER = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def ladder_rung(b: int) -> int:
    """Smallest ladder rung >= b. Callers cap b at PAD_LADDER[-1] first
    (the coalescer splits oversized buckets into top-rung chunks)."""
    if not 0 < b <= PAD_LADDER[-1]:
        raise ValueError(f"batch {b} outside (0, {PAD_LADDER[-1]}]")
    return PAD_LADDER[bisect.bisect_left(PAD_LADDER, b)]


@dataclass(frozen=True)
class LaunchUnit:
    """One simulated-compute quantum the gateway schedules on its decode
    engine pool. ``op_indices`` are positions in the ``execute`` op
    list; ``fraction`` is this unit's share of its physical launch's
    wall time (1.0 for a bucketed launch; a tile launch splits by tile
    ranges, one unit per op), so modeled-cost billing can charge
    ``decode_cost x fraction`` and still sum to one launch."""

    op_indices: tuple[int, ...]
    compute: float  # scaled seconds
    kind: str
    launch_id: int
    fraction: float = 1.0
    tiles: int = 0  # descriptor tiles this unit covers (0 = bucketed)


@dataclass
class CoalescerStats:
    decode_ops: int = 0  # logical reconstructions requested
    decode_calls: int = 0  # actual kernel launches issued
    padded_ops: int = 0  # ladder filler stripes launched (bucketed only)
    max_batch: int = 0  # most ops sharing one launch
    compute_time: float = 0.0  # scaled seconds, cumulative
    windows: int = 0  # execute() calls that had work
    staged_bytes: int = 0  # useful source bytes staged for kernels
    padded_bytes: int = 0  # filler staged alongside (tails, rungs)
    # ops-per-launch histogram. Bounded: at most one key per distinct
    # batch size (<= PAD_LADDER[-1] of them) — a week-long scenario run
    # does not accrete one int per launch.
    batch_hist: dict[int, int] = field(default_factory=dict)
    ops_by_kind: dict[str, int] = field(default_factory=dict)
    sources_by_kind: dict[str, int] = field(default_factory=dict)
    jit_entries: int = 0  # LIVE launch signatures (see below)
    jit_retraces: int = 0  # every signature ever started (churn)
    decode_shapes: int = 0  # distinct decode shape_keys ever executed
    # write-dataplane counters (kinds "EH"/"EV"): kept separate so a
    # read-only run's decode stats stay bit-identical with or without
    # the encode path compiled in
    encode_ops: int = 0  # logical encode ops requested
    encode_calls: int = 0  # encode kernel launches issued
    encode_compute_time: float = 0.0  # scaled seconds, cumulative
    encode_windows: int = 0  # execute_encode() calls that had work
    decode_out_bytes: int = 0  # bytes of the decode outputs execute() returned

    @property
    def coalescing_ratio(self) -> float:
        """ops per launch; > 1 means batching is happening."""
        return self.decode_ops / self.decode_calls if self.decode_calls else 0.0

    @property
    def launches_per_window(self) -> float:
        return self.decode_calls / self.windows if self.windows else 0.0

    @property
    def padded_byte_ratio(self) -> float:
        """Filler fraction of all bytes staged for decode kernels."""
        total = self.staged_bytes + self.padded_bytes
        return self.padded_bytes / total if total else 0.0

    def record_batch(self, n_ops: int) -> None:
        self.batch_hist[n_ops] = self.batch_hist.get(n_ops, 0) + 1
        self.max_batch = max(self.max_batch, n_ops)

    def sources_per_op(self, kind: str) -> float:
        """Mean source blocks per reconstruction of this kind — the
        paper's Table 1 costs: exactly t for "V", exactly k for "H"."""
        n = self.ops_by_kind.get(kind, 0)
        return self.sources_by_kind.get(kind, 0) / n if n else 0.0


class DecodeCoalescer:
    def __init__(
        self,
        compute_scale: float = 1.0,
        device: str | None = None,
        autotune_kernels: bool = True,
        mode: str = RAGGED,
    ):
        if mode not in (RAGGED, BUCKETED):
            raise ValueError(
                f"mode must be 'ragged' or 'bucketed', got {mode!r}"
            )
        self.compute_scale = compute_scale
        self.device = resolve_device(device)
        self.autotune_kernels = autotune_kernels
        self.mode = mode
        self.stats = CoalescerStats()
        self._warm: set[tuple] = set()  # launch signatures seen
        self._best: dict[tuple, float] = {}  # per-signature fastest run
        self._tuned: dict[str, autotune.TunedKernel] = {}
        self._shapes: set[tuple] = set()  # distinct op shape_keys seen
        # ragged-path state: grow-only caps (a new signature only on
        # growth keeps the signature set at the two chunk rungs for
        # steady traffic) and the reusable staging buffers, keyed
        # (kind, C).
        self._k_cap: dict[str, int] = {}
        self._tile_n: dict[str, int] = {}
        self._staging: dict[tuple, torch.Tensor] = {}

    def tiles_for(self, length: int, kind: str = "H") -> int:
        """Descriptor tiles one ``length``-byte output row costs at the
        current tile width (the ratcheted width once seen, else the
        same fit formula ``_execute_ragged_kind`` would pick). Used by
        per-tile modeled billing to price decode work that does not go
        through ``execute`` (background repair's codec)."""
        tn = self._tile_n.get(kind)
        if tn is None:
            tn = min(_rdk.DEFAULT_TILE_N, _next_pow2(max(1, int(length))))
        return -(-int(length) // tn)

    def jit_entries_by_kind(self) -> dict[str, int]:
        """Distinct live launch signatures per kind — the tile
        dataplane's O(1)-per-kind guarantee, observable."""
        out: dict[str, int] = {}
        for sig in self._warm:
            kind = sig[1][0] if sig[0] == BUCKETED else sig[1]
            out[kind] = out.get(kind, 0) + 1
        return out

    def _tuned_for(self, kind: str) -> autotune.TunedKernel | None:
        if not self.autotune_kernels:
            return None
        # encode kinds ("E*") only ever run ragged — there is no bucketed
        # encode baseline — so they always take the ragged tuners
        mode = RAGGED if kind.startswith("E") else self.mode
        key = f"{mode}:{kind}"
        tuned = self._tuned.get(key)
        if tuned is None:
            if mode == RAGGED:
                tune = (
                    autotune.tuned_ragged_xor
                    if kind in ("V", "EV")
                    else autotune.tuned_ragged_gf256
                )
            else:
                tune = autotune.tuned_xor if kind == "V" else autotune.tuned_gf256
            tuned = tune(self.device)
            self._tuned[key] = tuned
        return tuned

    def execute(
        self,
        decode_ops: list[DecodeOp],
        fetch: Callable[[BlockKey], np.ndarray],
    ) -> tuple[list[dict[int, np.ndarray]], list[LaunchUnit]]:
        """Run all ``decode_ops``; returns (results, units).

        ``results[i]`` maps target column -> reconstructed block for
        ``decode_ops[i]``. ``units`` are the simulated-compute quanta of
        the launches actually issued (see LaunchUnit): the gateway
        dispatches each unit onto its engine pool once the unit's ops'
        sources have landed, so one window's decode work can overlap
        other windows' fabric transfers and spread over engines."""
        results: list[dict[int, np.ndarray]] = [dict() for _ in decode_ops]
        units: list[LaunchUnit] = []
        if not decode_ops:
            return results, units
        self.stats.windows += 1
        for op in decode_ops:
            self._shapes.add(op.shape_key)
        if self.mode == RAGGED:
            by_kind: dict[str, list[int]] = defaultdict(list)
            for j, op in enumerate(decode_ops):
                by_kind[op.kind].append(j)
            for kind in sorted(by_kind):
                self._execute_ragged(
                    kind, by_kind[kind], decode_ops, fetch, results, units
                )
        else:
            # buckets split by byte length too (it is a launch shape key
            # anyway), so ragged-length windows stack cleanly
            buckets: dict[tuple, list[int]] = defaultdict(list)
            for i, op in enumerate(decode_ops):
                n = int(np.asarray(fetch(op.sources[0])).shape[-1])
                buckets[(op.shape_key, n)].append(i)
            for (key, _n), all_idxs in buckets.items():
                kind = key[0]
                tuned = self._tuned_for(kind)
                # buckets beyond the top rung split into top-rung launches
                cap = PAD_LADDER[-1]
                for c in range(0, len(all_idxs), cap):
                    self._launch_bucket(
                        key, kind, all_idxs[c : c + cap], tuned, decode_ops,
                        fetch, results, units,
                    )
        self.stats.decode_shapes = len(self._shapes)
        self.stats.decode_out_bytes += sum(a.nbytes for r in results for a in r.values())
        return results, units

    def execute_encode(
        self,
        encode_ops: list[DecodeOp],
        fetch: Callable[[BlockKey], np.ndarray],
    ) -> tuple[list[dict[int, np.ndarray]], list[LaunchUnit]]:
        """Run a PUT window's encode work in chunked tile launches:
        GF(256) parity-row generation ("EH" ops, coefficient rows from
        coding/rs.py's ``parity_matrix``) and XOR-delta parity folds
        ("EV" ops — stored parity plus any number of old^new row
        contributions, one op per touched parity block per window).

        Same interface and staging contract as ``execute``, but always
        via the ragged path (see ``_tuned_for``) and the separate
        kernels/ragged_encode.py entries, so encode signature
        growth is observable per kind and never touches the decode
        signatures.
        Source keys are whatever hashables ``fetch`` resolves — the
        gateway feeds host-staged old/new row arrays under synthetic
        tokens. Emitted LaunchUnits are billed on the engine pool by the
        gateway exactly like decode launches (best-observed kernel time,
        modeled-cost override, launch-wide readiness barrier)."""
        results: list[dict[int, np.ndarray]] = [dict() for _ in encode_ops]
        units: list[LaunchUnit] = []
        if not encode_ops:
            return results, units
        self.stats.encode_windows += 1
        by_kind: dict[str, list[int]] = defaultdict(list)
        for j, op in enumerate(encode_ops):
            assert op.kind.startswith("E"), f"not an encode kind: {op.kind!r}"
            by_kind[op.kind].append(j)
        for kind in sorted(by_kind):
            self._execute_ragged(
                kind, by_kind[kind], encode_ops, fetch, results, units
            )
        return results, units

    # -- ragged tile path -------------------------------------------------------
    def _execute_ragged(
        self, kind, idxs, decode_ops, fetch, results, units
    ) -> None:
        """Stage every op of ``kind`` as descriptor tiles and decode the
        whole set in chunked tile launches (see module docstring for
        the staging contract)."""
        tuned = self._tuned_for(kind)
        # fetch each distinct source once, straight into the gather below
        src: dict[BlockKey, np.ndarray] = {}
        # one descriptor row per OUTPUT row: (op_idx, target column,
        # coefficient bit-planes (K, 8) or None for XOR, sources, length)
        rows: list[tuple] = []
        for j in idxs:
            op = decode_ops[j]
            for s in op.sources:
                if s not in src:
                    src[s] = np.asarray(fetch(s))
            length = int(src[op.sources[0]].shape[-1])
            for s in op.sources[1:]:
                assert src[s].shape[-1] == length, (
                    f"ragged decode op sources must share a length: "
                    f"{src[s].shape[-1]} != {length}"
                )
            if kind in ("V", "EV"):
                rows.append((j, op.targets[0], None, op.sources, length))
            else:
                planes = expand_coeff_bitplanes(np.asarray(op.coeffs))
                for m, col in enumerate(op.targets):
                    rows.append((j, col, planes[m], op.sources, length))
        k_max = max(len(r[3]) for r in rows)
        self._k_cap[kind] = max(self._k_cap.get(kind, 0), k_max)
        k_cap = self._k_cap[kind]
        max_len = max(r[4] for r in rows)
        tn_fit = (
            tuned.block_n_for(max_len)
            if tuned is not None
            else min(_rdk.DEFAULT_TILE_N, _next_pow2(max_len))
        )
        self._tile_n[kind] = max(self._tile_n.get(kind, 0), tn_fit)
        tn = self._tile_n[kind]
        # cut rows into fixed-width tiles
        tiles: list[tuple[int, int, int]] = []  # (row index, offset, valid)
        out_rows = [np.empty(r[4], dtype=np.uint8) for r in rows]
        for ri, (_j, _col, _planes, _sources, length) in enumerate(rows):
            off = 0
            while off < length:
                valid = min(tn, length - off)
                tiles.append((ri, off, valid))
                off += valid
        pos = 0
        for c in _rdk.chunk_sizes(len(tiles)):
            self._launch_ragged_chunk(
                kind, c, tiles[pos : pos + c], rows, src, out_rows,
                tn, k_cap, units,
            )
            pos += c
        for ri, (j, col, _planes, _sources, _length) in enumerate(rows):
            results[j][col] = out_rows[ri]
        if kind.startswith("E"):
            self.stats.encode_ops += len(idxs)
        else:
            self.stats.decode_ops += len(idxs)
        self.stats.ops_by_kind[kind] = (
            self.stats.ops_by_kind.get(kind, 0) + len(idxs)
        )
        self.stats.sources_by_kind[kind] = self.stats.sources_by_kind.get(
            kind, 0
        ) + sum(len(decode_ops[j].sources) for j in idxs)

    def _buffer(self, key: tuple, nbytes: int) -> torch.Tensor:
        """Preallocated flat host staging buffer (pinned when the device
        is the card), reused across windows; replaced only when a
        grow-only cap (K, TN) ratchets."""
        buf = self._staging.get(key)
        if buf is None or buf.numel() != nbytes:
            pin = self.device.type == "cuda"
            buf = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=pin)
            self._staging[key] = buf
        return buf

    def _launch_ragged_chunk(
        self, kind, c, chunk_tiles, rows, src, out_rows, tn, k_cap, units
    ) -> None:
        """Gather one chunk of tiles into the staging buffer, copy it to
        the device in one blocking copy, run ONE tile launch, scatter
        outputs, and emit per-op LaunchUnits billed by tile share."""
        xor_kind = kind in ("V", "EV")
        n_data = c * k_cap * tn
        staging = self._buffer((kind, c), n_data + (0 if xor_kind else c * k_cap * 8))
        with host.span("coalescer.stage") as sp:
            flat = staging.numpy()
            flat.fill(0)
            data = flat[:n_data].reshape(c, k_cap, tn)
            mc = None if xor_kind else flat[n_data:].reshape(c, k_cap, 8)
            useful = 0
            for slot, (ri, off, valid) in enumerate(chunk_tiles):
                _j, _col, planes, sources, _length = rows[ri]
                for k, s in enumerate(sources):
                    data[slot, k, :valid] = src[s][off : off + valid]
                if mc is not None:
                    mc[slot, : planes.shape[0], :] = planes
                useful += valid * len(sources)
            sp.nbytes = useful
        device = self.device

        def launch() -> torch.Tensor:
            # one blocking host-to-device copy: the buffer is refilled
            # for the next chunk. Encode kinds route to the separate
            # ragged_encode entries, keeping encode and decode launch
            # counts and signature pools independently countable.
            dev = staging.to(device)
            d = dev[:n_data].view(c, k_cap, tn)
            if kind == "V":
                return ops.xor_ragged(d)
            if kind == "EV":
                return ops.xor_ragged_encode(d)
            m = dev[n_data:].view(c, k_cap, 8)
            if kind == "EH":
                return ops.gf256_ragged_encode(m, d)
            return ops.gf256_ragged(m, d)

        # Untimed warm-up on first sight of a launch signature: chunk
        # rung, K cap and tile width are the only shape keys, and the
        # one-off first-launch cost must not be billed to the window's
        # simulated decode latency.
        sig = (RAGGED, kind, c, k_cap, tn)
        if sig not in self._warm:
            # a grow-only cap ratchet obsoletes this kind's previous
            # signatures — they can never be launched again, so the LIVE
            # set stays at the two chunk rungs per kind; jit_retraces
            # keeps the cumulative count for churn visibility
            stale = {
                s
                for s in self._warm
                if s[0] == RAGGED and s[1] == kind and s[3:] != (k_cap, tn)
            }
            self._warm -= stale
            for s in stale:
                self._best.pop(s, None)
            if stale:
                _log.warning(
                    "coalescer: kind %r cap ratchet to (K=%d, TN=%d) "
                    "retired %d launch signature(s)",
                    kind, k_cap, tn, len(stale),
                )
            with host.span("coalescer.launch"):
                launch()
                synchronize(device)
            self._warm.add(sig)
            self.stats.jit_entries = len(self._warm)
            self.stats.jit_retraces += 1
        t0 = time.perf_counter()
        with host.span("coalescer.launch"):
            out = launch()
            synchronize(device)
        with host.span("coalescer.d2h", out.nbytes):
            out = out.cpu().numpy()
        dt = (time.perf_counter() - t0) * self.compute_scale
        best = self._best.get(sig)
        dt = dt if best is None or dt < best else best
        self._best[sig] = dt
        with host.span("coalescer.scatter", out.nbytes):
            for slot, (ri, off, valid) in enumerate(chunk_tiles):
                out_rows[ri][off : off + valid] = out[slot, :valid]
        # one unit per op, billed its tile share of the launch, so the
        # engine pool can spread this single launch across engines
        # (the gateway still gates all of them on the launch-wide
        # source barrier)
        encode = kind.startswith("E")
        launch_id = self.stats.encode_calls if encode else self.stats.decode_calls
        tiles_per_op = Counter(rows[ri][0] for ri, _off, _valid in chunk_tiles)
        n_valid = len(chunk_tiles)
        for j in sorted(tiles_per_op):
            frac = tiles_per_op[j] / n_valid
            units.append(
                LaunchUnit(
                    (j,), dt * frac, kind, launch_id, frac, tiles_per_op[j]
                )
            )
        if encode:
            self.stats.encode_calls += 1
            self.stats.encode_compute_time += dt
        else:
            self.stats.decode_calls += 1
            self.stats.compute_time += dt
        self.stats.record_batch(len(tiles_per_op))
        self.stats.staged_bytes += useful
        self.stats.padded_bytes += c * k_cap * tn - useful

    # -- bucketed baseline path -------------------------------------------------
    def _launch_bucket(
        self, key, kind, idxs, tuned, decode_ops, fetch, results, units
    ) -> None:
        """One stacked launch for ``idxs`` (all sharing shape ``key``),
        padded up the ladder; emits one LaunchUnit owning the whole
        batch and writes per-op ``results``."""
        b_pad = ladder_rung(len(idxs))
        first = decode_ops[idxs[0]]
        n = int(np.asarray(fetch(first.sources[0])).shape[-1])
        # gather every stripe straight into one (B_pad, K, N) host array;
        # ladder padding replicates the first stripe — same shape, same
        # coefficients, output rows sliced away below
        with host.span("coalescer.stage") as sp:
            data = np.empty((b_pad, len(first.sources), n), dtype=np.uint8)
            for b, i in enumerate(idxs):
                for k, s in enumerate(decode_ops[i].sources):
                    data[b, k] = fetch(s)
            data[len(idxs) :] = data[0]
            sp.nbytes = data.nbytes
        staged = torch.from_numpy(data)
        device = self.device
        block_n = None if tuned is None else tuned.block_n_for(n)
        if kind == "V":
            launch = lambda: ops.xor_parity_batched(  # noqa: E731
                staged.to(device), block_n=block_n
            )
        else:
            pad_idxs = idxs + [idxs[0]] * (b_pad - len(idxs))
            coefs = np.stack([decode_ops[i].coeffs for i in pad_idxs])  # (B, M, K)
            launch = lambda: ops.gf256_matmul_batched(  # noqa: E731
                coefs, staged.to(device), block_n=block_n
            )
        # Untimed warm-up on first sight of a launch signature: the
        # padded batch size B and byte length are the shape keys, and
        # the one-off first-launch cost must not be billed to the
        # window's simulated decode latency.
        sig = (BUCKETED, key, b_pad, n)
        if sig not in self._warm:
            with host.span("coalescer.launch"):
                launch()
                synchronize(device)
            self._warm.add(sig)
            self.stats.jit_entries = len(self._warm)
            self.stats.jit_retraces += 1
        t0 = time.perf_counter()
        with host.span("coalescer.launch"):
            out = launch()
            synchronize(device)
        with host.span("coalescer.d2h", out.nbytes):
            out = out.cpu().numpy()
        with host.span("coalescer.scatter", out.nbytes):
            if kind == "V":
                for b, i in enumerate(idxs):  # out: (B, N)
                    results[i][decode_ops[i].targets[0]] = out[b]
            else:
                for b, i in enumerate(idxs):  # out: (B, M, N)
                    for m, col in enumerate(decode_ops[i].targets):
                        results[i][col] = out[b, m]
        dt = (time.perf_counter() - t0) * self.compute_scale
        # bill at the signature's best-observed time (module docstring)
        best = self._best.get(sig)
        dt = dt if best is None or dt < best else best
        self._best[sig] = dt
        units.append(LaunchUnit(tuple(idxs), dt, kind, self.stats.decode_calls))
        stripe = int(np.prod(data.shape[1:]))  # bytes per staged stripe
        self.stats.staged_bytes += len(idxs) * stripe
        self.stats.padded_bytes += (b_pad - len(idxs)) * stripe
        self.stats.compute_time += dt
        self.stats.decode_calls += 1
        self.stats.decode_ops += len(idxs)
        self.stats.padded_ops += b_pad - len(idxs)
        self.stats.record_batch(len(idxs))
        self.stats.ops_by_kind[kind] = self.stats.ops_by_kind.get(kind, 0) + len(idxs)
        self.stats.sources_by_kind[kind] = self.stats.sources_by_kind.get(
            kind, 0
        ) + sum(len(decode_ops[i].sources) for i in idxs)
