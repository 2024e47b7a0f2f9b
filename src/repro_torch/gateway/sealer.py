"""Stripe sealing: pack many small tenant objects into one codeword row.

The warehouse-cluster study (Rashmi et al., 1309.0186) shows real object
traffic is dominated by objects far smaller than a stripe — encoding
each one as its own (k, q) row would waste almost the whole codeword on
zero padding and multiply parity overhead per byte. The sealer is the
gateway's packing buffer: small PUT payloads append into an open row of
``k x q`` bytes (journaled for durability the moment they arrive — the
append itself is the PUT's ack point); when the row fills, it SEALS —
becoming one immutable row object the gateway encodes through the same
ragged ENCODE megakernel window as full-row overwrites and places like
any other group row. Extents never span rows (a torn extent would need
two stripes decoded to read one object), so a payload that does not fit
the remaining space seals the open row early with a zero-padded tail —
zero bytes are identity under both codes, and the audit's ground truth
zero-fills the same way.

Each appended extent keeps a sha256 of its payload bytes: the end-to-end
consistency audit (``ObjectGateway.audit_sealed_stripes``) re-reads
every sealed extent through a store-only DEGRADED decode after fault
traces and compares digests — byte-identical or it counts as wrong.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Extent:
    """One small object's location inside a sealed (or open) row."""

    small_id: tuple  # caller's identity for the small object
    row_seq: int  # global sealed-row sequence number
    offset: int  # byte offset into the row's flat k*q payload
    length: int
    digest: str  # sha256 of the payload at append time
    tenant: str


class StripeSealer:
    """Packs small payloads into flat ``k*q``-byte rows, sealing a row
    when it fills (or early, when the next payload would span rows).
    ``append`` returns the rows sealed by that append — zero or one —
    as ``(row_seq, (k, q) row data, extents)`` tuples; ``flush`` seals
    the partial open row, and ``zero_row`` mints an empty filler row so
    the gateway can complete a group at drain time."""

    def __init__(self, k: int, q: int):
        if k < 1 or q < 1:
            raise ValueError(f"need k >= 1 and q >= 1, got ({k}, {q})")
        self.k = k
        self.q = q
        self.row_bytes = k * q
        self._buf = np.zeros(self.row_bytes, dtype=np.uint8)
        self._fill = 0
        self._extents: list[Extent] = []
        self._rows_sealed = 0

    @property
    def pending_bytes(self) -> int:
        return self._fill

    @property
    def pending_extents(self) -> int:
        return len(self._extents)

    @property
    def rows_sealed(self) -> int:
        return self._rows_sealed

    def append(
        self, small_id: tuple, payload: np.ndarray, tenant: str
    ) -> list[tuple[int, np.ndarray, list[Extent]]]:
        payload = np.asarray(payload, dtype=np.uint8).ravel()
        if payload.size < 1 or payload.size > self.row_bytes:
            raise ValueError(
                f"small-object payload must be 1..{self.row_bytes} bytes "
                f"(one row), got {payload.size}"
            )
        sealed = []
        if self._fill + payload.size > self.row_bytes:
            sealed.append(self._seal_row())
        ext = Extent(
            small_id=small_id,
            row_seq=self._rows_sealed,
            offset=self._fill,
            length=int(payload.size),
            digest=hashlib.sha256(payload.tobytes()).hexdigest(),
            tenant=tenant,
        )
        self._buf[self._fill : self._fill + payload.size] = payload
        self._fill += int(payload.size)
        self._extents.append(ext)
        if self._fill == self.row_bytes:
            sealed.append(self._seal_row())
        return sealed

    def flush(self) -> list[tuple[int, np.ndarray, list[Extent]]]:
        """Seal the partial open row (zero-padded tail), if any."""
        if not self._extents:
            return []
        return [self._seal_row()]

    def zero_row(self) -> tuple[int, np.ndarray, list[Extent]]:
        """An all-zero filler row with a fresh sequence number (pads the
        last group of a drain — matches load_objects' zero padding)."""
        assert not self._extents, "zero_row only between sealed rows"
        return self._seal_row()

    def _seal_row(self) -> tuple[int, np.ndarray, list[Extent]]:
        row = self._buf.copy().reshape(self.k, self.q)
        extents = self._extents
        seq = self._rows_sealed
        self._buf.fill(0)
        self._fill = 0
        self._extents = []
        self._rows_sealed += 1
        return (seq, row, extents)
