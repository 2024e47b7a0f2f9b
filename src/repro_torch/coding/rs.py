"""Systematic (n, k) Reed-Solomon code over GF(2^8).

Construction: start from the n x k Vandermonde matrix V[i, j] = alpha_i^j
with distinct evaluation points alpha_i (0..n-1). Every k x k submatrix of
V is invertible, so V generates an MDS code. Systematize by right-
multiplying with (V[:k])^{-1}: gen = V @ inv(V[:k]) = [I_k; P]. Row
operations preserve the any-k-rows-invertible property, so the systematic
code is MDS: any k of the n blocks recover the object.

The paper's §4 uses a [I_k, H] Vandermonde-parity form; for H to be MDS
one needs the systematized construction (raw Vandermonde parity is not MDS
for all (n, k)). This is noted in DESIGN.md and matches what production RS
implementations (ISA-L, jerasure) do.
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.coding import gf256
from repro_torch.coding.linear import LinearCode


@functools.lru_cache(maxsize=None)
def generator_matrix(n: int, k: int) -> np.ndarray:
    """Systematic MDS generator matrix (n, k), gen[:k] == I."""
    if not (0 < k <= n <= 256):
        raise ValueError(f"invalid RS parameters (n={n}, k={k})")
    vand = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        for j in range(k):
            vand[i, j] = gf256.pow_(i + 1, j)  # alpha_i = i+1 (nonzero, distinct)
    top_inv = gf256.np_inv_matrix(vand[:k])
    gen = gf256.np_matmul(vand, top_inv)
    assert np.array_equal(gen[:k], np.eye(k, dtype=np.uint8))
    return gen


@functools.lru_cache(maxsize=None)
def make_rs(n: int, k: int) -> LinearCode:
    return LinearCode(gen=generator_matrix(n, k))


def parity_matrix(n: int, k: int) -> np.ndarray:
    """The (m, k) parity part P: parities = P @ data."""
    return generator_matrix(n, k)[k:]
