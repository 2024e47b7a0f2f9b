"""Public entries over the GF(256) / XOR kernels.

Each entry takes tensors (or a numpy coefficient table, moved to the
data's device) and launches its CUDA kernel when the data lies on the
card, or runs the kernel's plain torch version when it lies on the CPU.
Launches are counted per kernel in ``LAUNCHES`` (see kernels/_build.py).

The single-op and batched entries pad the byte axis up to a ``block_n``
multiple (zero bytes are the identity of both products) and slice the
result back, as the reference package's do; ``block_n`` defaults to the
kernel's default capped at the next power of two of N. ``packed`` is
accepted for the reference's signatures and selects nothing here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import gf256_matmul as _gfk
from repro_torch.kernels import ragged_decode as _rdk
from repro_torch.kernels import ragged_encode as _rek
from repro_torch.kernels import xor_parity as _xpk
from repro_torch.kernels._build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.backend import as_u8


def _pad_to(x: torch.Tensor, mult: int, axis: int) -> tuple[torch.Tensor, int]:
    """``x`` zero-padded along ``axis`` to a multiple of ``mult`` (a copy
    only when padding is needed), and the original length."""
    n = x.shape[axis]
    rem = (-n) % mult
    if rem == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = n + rem
    out = x.new_zeros(shape)
    out.narrow(axis, 0, n).copy_(x)
    return out, n


def _planes(coefs, device: torch.device) -> torch.Tensor:
    """(..., M, K) host coefficients -> (..., M, K, 8) bit-planes on ``device``."""
    if isinstance(coefs, torch.Tensor):
        coefs = coefs.cpu().numpy()
    coefs = np.asarray(coefs, dtype=np.uint8)
    planes = _gfk.expand_coeff_bitplanes(coefs.reshape(-1, coefs.shape[-1]))
    return torch.from_numpy(planes.reshape(*coefs.shape, 8)).to(device)


def gf256_matmul(coef, data: torch.Tensor, *, block_n: int | None = None,
                 packed: bool = False) -> torch.Tensor:
    """C (M, N) = coef (M, K) @ data (K, N) over GF(2^8): one K5 launch.
    ``coef`` is a host-side matrix (generator / repair coefficients)."""
    data = as_u8(data)
    n = data.shape[-1]
    if block_n is None:
        block_n = min(_gfk.DEFAULT_BLOCK_N, _next_pow2(n))
    data_p, orig_n = _pad_to(data, block_n, axis=-1)
    out = _gfk.gf256_matmul_planes(
        _planes(coef, data.device), data_p, block_n=block_n, packed=packed
    )
    return out[:, :orig_n]


def xor_parity(data: torch.Tensor, *, block_n: int | None = None) -> torch.Tensor:
    """data (T, N) uint8 -> (N,) XOR over rows: one K7 launch."""
    data = as_u8(data)
    n = data.shape[-1]
    if block_n is None:
        block_n = min(_xpk.DEFAULT_BLOCK_N, _next_pow2(n))
    data_p, orig_n = _pad_to(data, block_n, axis=-1)
    return _xpk.xor_parity(data_p, block_n=block_n)[:orig_n]


def gf256_matmul_batched(coefs, data: torch.Tensor, *, block_n: int | None = None,
                         packed: bool = False) -> torch.Tensor:
    """Stacked decode: out (B, M, N) = coefs (B, M, K) @ data (B, K, N),
    each batch element an independent GF(2^8) product, in ONE K6 launch
    (the bucketed coalescer's degraded-read decode)."""
    data = as_u8(data)
    n = data.shape[-1]
    if block_n is None:
        block_n = min(_gfk.DEFAULT_BLOCK_N, _next_pow2(n))
    data_p, orig_n = _pad_to(data, block_n, axis=-1)
    out = _gfk.gf256_matmul_planes_batched(
        _planes(coefs, data.device), data_p, block_n=block_n, packed=packed
    )
    return out[..., :orig_n]


def xor_parity_batched(data: torch.Tensor, *, block_n: int | None = None) -> torch.Tensor:
    """data (B, T, N) uint8 -> (B, N): batched XOR over rows, one launch."""
    data = as_u8(data)
    n = data.shape[-1]
    if block_n is None:
        block_n = min(_xpk.DEFAULT_BLOCK_N, _next_pow2(n))
    data_p, orig_n = _pad_to(data, block_n, axis=-1)
    return _xpk.xor_parity_batched(data_p, block_n=block_n)[..., :orig_n]


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


def rs_encode(parity_matrix, data: torch.Tensor, **kw) -> torch.Tensor:
    """RS parity blocks (m, q) from data blocks (k, q)."""
    return gf256_matmul(parity_matrix, data, **kw)


def rs_decode(inverse, survivors: torch.Tensor, **kw) -> torch.Tensor:
    """Message blocks (k, q) = decode-inverse (k, k) @ survivors (k, q)."""
    return gf256_matmul(inverse, survivors, **kw)


def _next_pow2(n: int) -> int:
    p = 128
    while p < n:
        p *= 2
    return p
