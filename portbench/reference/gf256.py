"""GF(2^8) arithmetic for the plain reference.

The field is GF(2)[x] / (x^8 + x^4 + x^3 + x + 1), the polynomial a
configuration names under ``code.field_poly`` (0x11B). The product table
is built here by shift-and-add, with no log tables, and the matrix
helpers are plain Gauss-Jordan: nothing is shared with the program.

Block arithmetic runs on torch uint8 tensors wherever they lie (the card
after the window closes, the CPU in tests); the tables and the small
matrices are NumPy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def mul_table(poly: int) -> np.ndarray:
    """(256, 256) uint8 product table of GF(2^8) modulo ``poly``."""
    a = np.arange(256, dtype=np.int64)[:, None].repeat(256, axis=1)
    b = np.arange(256, dtype=np.int64)[None, :].repeat(256, axis=0)
    out = np.zeros((256, 256), dtype=np.int64)
    for _ in range(8):
        out ^= np.where(b & 1, a, 0)
        a = a << 1
        a = np.where(a & 0x100, a ^ poly, a)
        b = b >> 1
    return out.astype(np.uint8)


def inverse(poly: int) -> np.ndarray:
    """(256,) multiplicative inverses; inverse(0) is 0 and never used."""
    table = mul_table(poly)
    inv = np.zeros(256, dtype=np.uint8)
    for a in range(1, 256):
        inv[a] = int(np.flatnonzero(table[a] == 1)[0])
    return inv


def power(a: int, e: int, poly: int) -> int:
    table = mul_table(poly)
    out = 1
    for _ in range(e):
        out = int(table[out, a])
    return out


def mat_mul(a: np.ndarray, b: np.ndarray, poly: int) -> np.ndarray:
    """(M, K) @ (K, N) over GF(2^8), small host matrices."""
    table = mul_table(poly)
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            acc = 0
            for k in range(a.shape[1]):
                acc ^= int(table[a[i, k], b[k, j]])
            out[i, j] = acc
    return out


def mat_inv(m: np.ndarray, poly: int) -> np.ndarray:
    """Inverse of a square matrix over GF(2^8) by Gauss-Jordan."""
    table, inv = mul_table(poly), inverse(poly)
    n = m.shape[0]
    aug = np.concatenate([m.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = next(r for r in range(col, n) if aug[r, col])
        aug[[col, pivot]] = aug[[pivot, col]]
        aug[col] = table[inv[aug[col, col]], aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= table[aug[r, col], aug[col]]
    return aug[:, n:]


# bytes of a block converted to int64 indices at a time on the device
_SLAB = 1 << 24


def scale(c: int, x: torch.Tensor, poly: int) -> torch.Tensor:
    """c * x elementwise for a uint8 tensor ``x``, by table lookup."""
    if c == 0:
        return torch.zeros_like(x)
    if c == 1:
        return x.clone()
    row = torch.from_numpy(mul_table(poly)[c].copy()).to(x.device)
    flat = x.reshape(-1)
    out = torch.empty_like(flat)
    for s in range(0, flat.numel(), _SLAB):
        out[s : s + _SLAB] = row[flat[s : s + _SLAB].long()]
    return out.view(x.shape)


def combine(coeffs: np.ndarray, blocks: torch.Tensor, poly: int) -> torch.Tensor:
    """(M, K) coefficients times (K, q) blocks -> (M, q) over GF(2^8)."""
    out = torch.zeros((coeffs.shape[0], blocks.shape[-1]), dtype=torch.uint8,
                      device=blocks.device)
    for i in range(coeffs.shape[0]):
        for k in range(coeffs.shape[1]):
            if coeffs[i, k]:
                out[i] ^= scale(int(coeffs[i, k]), blocks[k], poly)
    return out
