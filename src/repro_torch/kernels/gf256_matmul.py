"""GF(2^8) coefficient-matrix x block-data products (K5, K6) and the
coefficient bit-plane expansion shared by every GF kernel.

RS encode (parity = P @ data), RS erasure decode (message = Inv @
survivors) and repair (missing = Coef @ sources) are all ``small
coefficient matrix (M, K) x large byte matrix (K, N)`` products over
GF(2^8). Every GF kernel takes its coefficients as bit-planes:

    gfmul(c, x) = XOR_{b=0..7} ((x >> b) & 1) * gfmul(c, 2^b)

so the 8 constants gfmul(c, 2^b) per coefficient are precomputed
host-side and the kernel body is shifts, masks and XORs — no tables.

The kernels are CUDA C++ (``csrc/gf_matmul_xor.cu``, see its header for
the design and what bounds it on the card); each wrapper launches the
kernel for a CUDA tensor and runs the plain torch version beside it for
a CPU tensor. The CUDA path never falls back: a refused launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.coding import gf256
from repro_torch.kernels import _build
from repro_torch.kernels.backend import check_cuda_operands, raw_stream, reject_dtensor

DEFAULT_BLOCK_N = 32768


def expand_coeff_bitplanes(coef: np.ndarray) -> np.ndarray:
    """(M, K) uint8 coefficient matrix -> (M, K, 8) bit-plane constants
    Mc[i, k, b] = gfmul(coef[i, k], 2^b). Host-side, tiny."""
    coef = np.asarray(coef, dtype=np.uint8)
    planes = np.stack(
        [gf256._MUL_NP[coef, 1 << b] for b in range(8)], axis=-1
    )  # (M, K, 8)
    return planes.astype(np.uint8)


def gf_matmul_plain(mc: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Plain torch version: (..., M, K, 8) planes x (..., K, N) data ->
    (..., M, N). Accumulates one (k, bit) plane at a time, so the working
    set is the output plus one (..., M, N) temporary, never an
    (..., M, K, N) intermediate."""
    kk, n = data.shape[-2:]
    out = torch.zeros((*mc.shape[:-2], n), dtype=torch.uint8, device=data.device)
    for k in range(kk):
        x = data[..., k, :].unsqueeze(-2)  # (..., 1, N)
        for b in range(8):
            bits = torch.bitwise_and(torch.bitwise_right_shift(x, b), 1)
            out ^= bits * mc[..., k, b].unsqueeze(-1)
    return out


def _check(mc: torch.Tensor, data: torch.Tensor, block_n: int, batched: bool) -> None:
    lead = 1 if batched else 0
    if mc.dtype != torch.uint8 or data.dtype != torch.uint8:
        raise ValueError(f"mc and data must be uint8, got {mc.dtype} and {data.dtype}")
    if mc.dim() != 3 + lead or mc.shape[-1] != 8 or data.dim() != 2 + lead:
        want = "(B, M, K, 8) and (B, K, N)" if batched else "(M, K, 8) and (K, N)"
        raise ValueError(f"mc, data must be {want}, got {tuple(mc.shape)}, {tuple(data.shape)}")
    if mc.shape[-2] != data.shape[-2] or mc.shape[:lead] != data.shape[:lead]:
        raise ValueError(f"shapes differ: mc {tuple(mc.shape)}, data {tuple(data.shape)}")
    if 0 in mc.shape or 0 in data.shape:
        raise ValueError(f"empty operand: mc {tuple(mc.shape)}, data {tuple(data.shape)}")
    if data.shape[-1] % block_n:
        raise ValueError(f"N = {data.shape[-1]} is not a multiple of block_n = {block_n}")
    if mc.device != data.device:
        raise ValueError(f"mc on {mc.device}, data on {data.device}")


def _launch(mc: torch.Tensor, data: torch.Tensor, block_n: int, batched: bool) -> torch.Tensor:
    reject_dtensor("gf256_matmul_planes", mc, data)
    _check(mc, data, block_n, batched)
    if data.device.type == "cpu":
        return gf_matmul_plain(mc, data)
    check_cuda_operands(block_n, "block_n", data, mc)
    *lead, m, kk, _ = mc.shape
    n = data.shape[-1]
    out = torch.empty((*lead, m, n), dtype=torch.uint8, device=data.device)
    stream = raw_stream(data.device)
    if batched:
        _build.launch("gf256_matmul_planes_batched", mc.data_ptr(), data.data_ptr(),
                      out.data_ptr(), lead[0], m, kk, n, block_n, stream)
    else:
        _build.launch("gf256_matmul_planes", mc.data_ptr(), data.data_ptr(),
                      out.data_ptr(), m, kk, n, block_n, stream)
    return out


def gf256_matmul_planes(
    mc: torch.Tensor,
    data: torch.Tensor,
    *,
    block_n: int = DEFAULT_BLOCK_N,
    packed: bool = False,
) -> torch.Tensor:
    """K5: C (M, N) = coefficient matrix x data over GF(2^8).

    mc: (M, K, 8) bit-plane constants (see expand_coeff_bitplanes);
    data: (K, N) uint8 with N a multiple of ``block_n`` (ops.py pads).
    On the card ``block_n`` is the bytes one thread block covers.
    ``packed`` is accepted for the reference's signature and selects
    nothing: there is one CUDA body, the u32 mask-spread algebra.
    Replaces src/repro/kernels/gf256_matmul.py ``gf256_matmul_planes``."""
    del packed
    return _launch(mc, data, block_n, batched=False)


def gf256_matmul_planes_batched(
    mc: torch.Tensor,
    data: torch.Tensor,
    *,
    block_n: int = DEFAULT_BLOCK_N,
    packed: bool = False,
) -> torch.Tensor:
    """K6: stacked products, (B, M, K, 8) bit-planes x (B, K, N) data ->
    (B, M, N), in ONE launch: B stripes that share a decode shape but not
    coefficients (the bucketed coalescer's case). ``block_n`` and
    ``packed`` as for ``gf256_matmul_planes``. Replaces
    src/repro/kernels/gf256_matmul.py ``gf256_matmul_planes_batched``."""
    del packed
    return _launch(mc, data, block_n, batched=True)
