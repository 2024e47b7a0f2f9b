"""Public entries over the tile kernels.

Each entry takes tensors (or a numpy coefficient table, moved to the
data's device) and launches its CUDA kernel when the data lies on the
card, or runs the kernel's plain torch version when it lies on the CPU.
Launches are counted per kernel in ``LAUNCHES`` (see kernels/_build.py).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ragged_decode as _rdk
from repro_torch.kernels import ragged_encode as _rek
from repro_torch.kernels._build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.backend import as_u8


def gf256_ragged(mc, data: torch.Tensor) -> torch.Tensor:
    """Ragged decode entry: ONE launch over C fixed-width tiles of MIXED
    GF(256) decode ops (see kernels/ragged_decode.py for the layout).
    mc: (C, K, 8) per-tile coefficient bit-planes; data: (C, K, TN)
    per-tile source slabs -> (C, TN)."""
    return _rdk.ragged_gf256_tiles(as_u8(mc, data.device), as_u8(data))


def xor_ragged(data: torch.Tensor) -> torch.Tensor:
    """Ragged decode entry for vertical XOR repairs: data (C, K, TN) ->
    (C, TN), one launch for a chunk of mixed tiles."""
    return _rdk.ragged_xor_tiles(as_u8(data))


def gf256_ragged_encode(mc, data: torch.Tensor) -> torch.Tensor:
    """Ragged ENCODE entry: ONE launch over C tiles of MIXED GF(256)
    parity encodes (coefficients from coding/rs.py's ``parity_matrix``).
    Same tile contract as ``gf256_ragged``, its own kernel entry."""
    return _rek.ragged_gf256_encode_tiles(as_u8(mc, data.device), as_u8(data))


def xor_ragged_encode(data: torch.Tensor) -> torch.Tensor:
    """Ragged ENCODE entry for XOR-delta parity folds: data (C, K, TN)
    -> (C, TN). Zero-padded K rows / tail bytes are the XOR identity."""
    return _rek.ragged_xor_encode_tiles(as_u8(data))


def _next_pow2(n: int) -> int:
    p = 128
    while p < n:
        p *= 2
    return p
