"""Generic systematic linear erasure codes over GF(2^8).

A code is described by its (n, k) generator matrix ``gen`` (numpy uint8,
shape (n, k)): stored block i is ``c_i = XOR_j gen[i, j] * o_j`` where
``o`` is the k-symbol (k-block) message. Systematic codes have
``gen[:k] == I_k``.

Erasure decoding = picking k available rows whose submatrix is invertible
and solving. This module provides the host-side solver machinery shared by
RS / LRC / product-code decoders, plus rank-based decodability checks used
by the Monte-Carlo analysis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.coding import gf256
from repro_torch.kernels.backend import as_u8


def rank_gf256(m: np.ndarray) -> int:
    """Rank of a matrix over GF(2^8) via Gaussian elimination (host-side)."""
    a = m.astype(np.uint8).copy()
    rows, cols = a.shape
    rank = 0
    for col in range(cols):
        pivot = None
        for row in range(rank, rows):
            if a[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            continue
        if pivot != rank:
            a[[rank, pivot]] = a[[pivot, rank]]
        pinv = gf256._INV_NP[a[rank, col]]
        a[rank] = gf256._MUL_NP[pinv, a[rank]]
        for row in range(rows):
            if row != rank and a[row, col] != 0:
                a[row] ^= gf256._MUL_NP[a[row, col], a[rank]]
        rank += 1
        if rank == rows:
            break
    return rank


@dataclass(frozen=True)
class LinearCode:
    """An (n, k) linear code over GF(2^8) given by its generator matrix."""

    gen: np.ndarray  # (n, k) uint8

    @property
    def n(self) -> int:
        return self.gen.shape[0]

    @property
    def k(self) -> int:
        return self.gen.shape[1]

    def encode(self, data, device=None) -> torch.Tensor:
        """data: (..., k, q) uint8 -> (..., n, q) codeword blocks, on
        ``device`` (default: a tensor's own device, else the card)."""
        return gf256.matmul(self.gen, as_u8(data, device))  # (..., n, q)

    def decodable(self, available: np.ndarray) -> bool:
        """Can the k message blocks be recovered from ``available`` rows?"""
        avail_rows = self.gen[np.asarray(available, dtype=np.int64)]
        if avail_rows.shape[0] < self.k:
            return False
        return rank_gf256(avail_rows) == self.k

    def decode_matrix(self, available: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Pick k independent available rows; return (row_ids, inverse).

        ``inverse`` (k, k) satisfies: message = inverse @ c[row_ids].
        Raises ValueError if not decodable.
        """
        available = np.asarray(available, dtype=np.int64)
        chosen: list[int] = []
        basis = np.zeros((0, self.k), dtype=np.uint8)
        for idx in available:
            cand = np.concatenate([basis, self.gen[idx : idx + 1]], axis=0)
            if rank_gf256(cand) > basis.shape[0]:
                basis = cand
                chosen.append(int(idx))
                if len(chosen) == self.k:
                    break
        if len(chosen) < self.k:
            raise ValueError(
                f"undecodable: only rank {len(chosen)} from {len(available)} rows"
            )
        sub = self.gen[np.asarray(chosen)]
        return np.asarray(chosen), gf256.np_inv_matrix(sub)

    def decode(self, available: np.ndarray, blocks, device=None) -> torch.Tensor:
        """Recover message blocks (k, q) from available codeword blocks.

        ``blocks``: (len(available), q) rows aligned with ``available``.
        """
        available = np.asarray(available, dtype=np.int64)
        row_ids, inverse = self.decode_matrix(available)
        pos = {int(a): i for i, a in enumerate(available)}
        sel = [pos[int(r)] for r in row_ids]
        return gf256.matmul(inverse, as_u8(blocks, device)[sel])

    def repair_matrix(
        self, available: np.ndarray, missing: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Return (row_ids, coeffs) s.t. c[missing] = coeffs @ c[row_ids]."""
        row_ids, inverse = self.decode_matrix(available)
        miss_gen = self.gen[np.asarray(missing, dtype=np.int64)]  # (r, k)
        coeffs = gf256.np_matmul(miss_gen, inverse)  # (r, k)
        return row_ids, coeffs

    def repair(
        self, available: np.ndarray, blocks, missing: np.ndarray, device=None
    ) -> torch.Tensor:
        """Reconstruct the ``missing`` codeword blocks: (r, q)."""
        available = np.asarray(available, dtype=np.int64)
        row_ids, coeffs = self.repair_matrix(available, missing)
        pos = {int(a): i for i, a in enumerate(available)}
        sel = [pos[int(r)] for r in row_ids]
        return gf256.matmul(coeffs, as_u8(blocks, device)[sel])
