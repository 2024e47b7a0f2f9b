"""GF(2^8) arithmetic on torch uint8 tensors.

The field is F_{2^8} with the standard AES/Rijndael reduction polynomial
x^8 + x^4 + x^3 + x + 1 (0x11B). Elements are uint8. Addition is XOR.
Multiplication uses log/exp tables generated once at import time with
numpy (host-side); the tensor ops below run on the device of their
tensor operand.

Conventions used throughout the codebase:
  * ``LOG[0]`` is never read on the fast path — multiplication masks zero
    operands explicitly.
  * ``EXP`` is doubled (length 510) so ``EXP[LOG[a] + LOG[b]]`` needs no
    modular reduction.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Table generation (host-side, numpy)
# ---------------------------------------------------------------------------

_POLY = 0x11B  # x^8 + x^4 + x^3 + x + 1
_GENERATOR = 0x03  # 3 is a primitive element for 0x11B


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(510, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        # multiply x by the generator (0x03 = x + 1): x*3 = (x<<1) ^ x
        x = (x << 1) ^ x
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[0:255]
    return exp, log


_EXP_NP, _LOG_NP = _build_tables()

# Full 256x256 multiplication table (64 KiB) — used by the reference paths
# and for building per-matrix lookup tables. Host-side only.
_MUL_NP = np.zeros((256, 256), dtype=np.uint8)
_nz = np.arange(1, 256)
_MUL_NP[1:, 1:] = _EXP_NP[(_LOG_NP[_nz][:, None] + _LOG_NP[_nz][None, :])]

_INV_NP = np.zeros(256, dtype=np.uint8)
_INV_NP[1:] = _EXP_NP[255 - _LOG_NP[_nz]]


# ---------------------------------------------------------------------------
# torch-facing API (runs where the tensor operand lies)
# ---------------------------------------------------------------------------

def _u8(x) -> torch.Tensor:
    """``x`` as a uint8 tensor where it lies (a numpy array: on the host)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t if t.dtype == torch.uint8 else t.to(torch.uint8)


def exp_table(device: torch.device | None = None) -> torch.Tensor:
    return torch.from_numpy(_EXP_NP.copy()).to(device or "cpu")


def log_table(device: torch.device | None = None) -> torch.Tensor:
    return torch.from_numpy(_LOG_NP.copy()).to(device or "cpu")


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field addition == XOR (also subtraction)."""
    return torch.bitwise_xor(a, b)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise field multiplication via the 256x256 product table."""
    a, b = torch.broadcast_tensors(_u8(a), _u8(b))
    table = torch.from_numpy(_MUL_NP).to(a.device)
    return table[a.long(), b.long()]


def inv(a: torch.Tensor) -> torch.Tensor:
    """Elementwise multiplicative inverse. inv(0) := 0 (never used)."""
    a = _u8(a)
    return torch.from_numpy(_INV_NP).to(a.device)[a.long()]


def pow_(a: int, e: int) -> int:
    """Host-side scalar power (for generator-matrix construction)."""
    if e == 0:
        return 1
    if a == 0:
        return 0
    return int(_EXP_NP[(int(_LOG_NP[a]) * e) % 255])


def mul_scalar_np(a: int, b: int) -> int:
    return int(_MUL_NP[a, b])


def matmul(a, b: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matrix multiply: C[i,j] = XOR_k a[i,k]*b[k,j].

    a: (M, K) uint8 (numpy or tensor), b: (..., K, N) uint8 tensor ->
    (..., M, N) uint8 on b's device (batched over b's leading dims).
    The plain torch path (the CUDA tile kernels in repro_torch.kernels
    carry the gateway's hot path).

    Memory: the product is accumulated one (k, bit) plane at a time —
    ``out[..., m, :] ^= ((b_k >> bit) & 1) * gfmul(a[m,k], 2^bit)`` — so
    the working set is the output plus one (..., N) temporary, never the
    (..., M, K, N) intermediate a broadcast product would build (tens of
    GB at 64 MiB blocks). The bytes are those of the table product.
    """
    b = _u8(b)
    coef = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    coef = coef.astype(np.uint8)
    m_rows, kk = coef.shape
    if b.shape[-2] != kk:
        raise ValueError(f"inner dims differ: {coef.shape} @ {tuple(b.shape)}")
    # planes[m, k, bit] = gfmul(coef[m, k], 2^bit), host-side and tiny
    planes = np.stack([_MUL_NP[coef, 1 << bit] for bit in range(8)], axis=-1)
    out = torch.zeros(
        (*b.shape[:-2], m_rows, b.shape[-1]), dtype=torch.uint8, device=b.device
    )
    for k in range(kk):
        x = b[..., k, :]
        for bit in range(8):
            cols = [m for m in range(m_rows) if planes[m, k, bit]]
            if not cols:
                continue
            sel = torch.bitwise_and(torch.bitwise_right_shift(x, bit), 1)
            for m in cols:
                out[..., m, :] ^= sel * int(planes[m, k, bit])
    return out


def xor_reduce(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """XOR-reduce along ``axis`` (vertical-parity primitive)."""
    x = _u8(x)
    axis %= x.ndim
    if x.shape[axis] == 0:
        return torch.zeros(
            x.shape[:axis] + x.shape[axis + 1 :], dtype=torch.uint8, device=x.device
        )
    out = x.select(axis, 0).clone()
    for i in range(1, x.shape[axis]):
        out ^= x.select(axis, i)
    return out


# ---------------------------------------------------------------------------
# Host-side matrix helpers over GF(2^8) (numpy; used for generator matrices
# and erasure-decoding matrix inversion — all small: n, k <= a few dozen)
# ---------------------------------------------------------------------------

def np_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host-side GF matmul for small matrices: (M,K) @ (K,N)."""
    a = a.astype(np.uint8)
    b = b.astype(np.uint8)
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for k in range(a.shape[1]):
        out ^= _MUL_NP[a[:, k][:, None], b[k, :][None, :]]
    return out


def np_inv_matrix(m: np.ndarray) -> np.ndarray:
    """Host-side Gauss-Jordan inversion over GF(2^8). Raises if singular."""
    m = m.astype(np.uint8).copy()
    n = m.shape[0]
    assert m.shape == (n, n)
    aug = np.concatenate([m, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if aug[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise np.linalg.LinAlgError("singular GF(256) matrix")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        pinv = _INV_NP[aug[col, col]]
        aug[col] = _MUL_NP[pinv, aug[col]]
        for row in range(n):
            if row != col and aug[row, col] != 0:
                aug[row] ^= _MUL_NP[aug[row, col], aug[col]]
    return aug[:, n:]
