"""The (n, k, t) CORE product code (paper §4).

Horizontal code: systematic MDS (n, k) Reed-Solomon per object (row).
Vertical code: (t+1, t) single parity check across objects (columns).
Codeword matrix: (t+1) rows x n columns of q-byte blocks; rows 0..t-1 are
the encoded objects, row t is the column-wise XOR parity.

By linearity of both codes the parity row is itself a valid RS(n, k)
codeword (of the XOR of the t objects), so horizontal repair applies to
the parity row too. This property is what makes scheduling (§6.3)
two-dimensional.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.coding import gf256, rs, spc
from repro_torch.coding.linear import LinearCode
from repro_torch.kernels.backend import as_u8, resolve_device


@dataclass(frozen=True)
class CoreCode:
    """Parameters of a (n, k, t) CORE product code."""

    n: int
    k: int
    t: int

    def __post_init__(self):
        if not (0 < self.k <= self.n):
            raise ValueError(f"bad (n={self.n}, k={self.k})")
        if self.t < 1:
            raise ValueError("t >= 1 required")

    @property
    def m(self) -> int:
        return self.n - self.k

    @property
    def rows(self) -> int:
        return self.t + 1

    @property
    def stretch(self) -> float:
        return (self.n * (self.t + 1)) / (self.k * self.t)

    @property
    def horizontal(self) -> LinearCode:
        return rs.make_rs(self.n, self.k)

    # -- costs used by scheduling / analysis (block reads) ------------------
    @property
    def vertical_cost(self) -> int:
        return self.t

    @property
    def horizontal_cost(self) -> int:
        return self.k


def _xor_rows(m: torch.Tensor) -> torch.Tensor:
    return gf256.xor_reduce(m, axis=0)


@dataclass(frozen=True)
class CoreCodec:
    """Encode / repair engine for a CORE product code over block arrays.

    ``device``: where the codec math runs — ``None``/``"cuda"`` is the
    card (raises without CUDA), ``"cpu"`` the host. Inputs may be numpy
    arrays or tensors; results are tensors on that device."""

    code: CoreCode
    device: str | None = None

    @property
    def torch_device(self) -> torch.device:
        return resolve_device(self.device)

    def _put(self, x) -> torch.Tensor:
        return as_u8(x, self.torch_device)

    def encode(self, objects) -> torch.Tensor:
        """objects: (t, k, q) uint8 -> full CORE matrix (t+1, n, q).

        Mirrors the paper's implementation: horizontal RS per object first,
        then one vertical XOR parity row across data AND parity columns.
        """
        c = self.code
        if objects.shape[:2] != (c.t, c.k):
            raise ValueError(f"expected {(c.t, c.k)} leading dims, got {objects.shape}")
        horiz = self.code.horizontal.encode(self._put(objects))  # (t, n, q)
        parity_row = _xor_rows(horiz)  # (n, q)
        return torch.cat([horiz, parity_row[None]], dim=0)

    def decode_object(self, row_blocks, available: np.ndarray) -> torch.Tensor:
        """Recover one object's (k, q) data from >=k available blocks of its row."""
        return self.code.horizontal.decode(available, self._put(row_blocks))

    def repair_vertical(self, column_blocks) -> torch.Tensor:
        """Repair the single missing block of a column from its t survivors.

        column_blocks: (t, q) — the surviving blocks of that column.
        """
        c = self.code
        if column_blocks.shape[0] != c.t:
            raise ValueError(f"vertical repair needs exactly t={c.t} survivors")
        return spc.repair(self._put(column_blocks), axis=0)

    def repair_horizontal(
        self, row_blocks, available: np.ndarray, missing: np.ndarray
    ) -> torch.Tensor:
        """Repair ``missing`` blocks of a row from >=k available blocks."""
        return self.code.horizontal.repair(available, self._put(row_blocks), missing)

    def verify(self, matrix) -> bool:
        """Check product-code consistency of a full (t+1, n, q) matrix."""
        c = self.code
        matrix = self._put(matrix)
        ok_v = bool(torch.all(_xor_rows(matrix) == 0))
        reenc = self.code.horizontal.encode(matrix[:, : c.k])
        ok_h = bool(torch.all(reenc == matrix))
        return ok_v and ok_h
