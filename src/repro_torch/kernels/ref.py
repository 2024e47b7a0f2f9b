"""Plain torch oracles for the tile kernels (the reference
implementations the kernels are validated against in tests)."""

from __future__ import annotations

import torch

from repro_torch.coding import gf256


def gf256_matmul(coef, data: torch.Tensor) -> torch.Tensor:
    """C (M, N) = coef (M, K) x data (K, N) over GF(2^8)."""
    return gf256.matmul(coef, data)


def xor_parity(data: torch.Tensor) -> torch.Tensor:
    """data (T, N) -> (N,) XOR of rows."""
    return gf256.xor_reduce(data, axis=0)
