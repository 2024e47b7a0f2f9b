"""Vertical XOR parity / repair (K7): out (N,) = XOR over the T rows of
data (T, N), and its batched form (B, T, N) -> (B, N).

Pure byte XOR: the paper's cheap vertical operation, bound by the bytes
it moves. The kernel is CUDA C++ (``csrc/gf_matmul_xor.cu``,
``xor_rows_kernel``); each wrapper launches it for a CUDA tensor and runs
the plain torch version beside it for a CPU tensor. The CUDA path never
falls back: a refused launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.backend import check_cuda_operands, raw_stream, reject_dtensor

DEFAULT_BLOCK_N = 65536


def xor_rows_plain(data: torch.Tensor) -> torch.Tensor:
    """Plain torch version: (..., T, N) -> (..., N), XOR over T."""
    out = data[..., 0, :].clone()
    for t in range(1, data.shape[-2]):
        out ^= data[..., t, :]
    return out


def _launch(data: torch.Tensor, block_n: int, batched: bool) -> torch.Tensor:
    reject_dtensor("xor_parity", data)
    want = 3 if batched else 2
    if data.dtype != torch.uint8 or data.dim() != want:
        shape = "(B, T, N)" if batched else "(T, N)"
        raise ValueError(f"data must be {shape} uint8, got {data.dtype} {tuple(data.shape)}")
    if 0 in data.shape:
        raise ValueError(f"empty operand {tuple(data.shape)}")
    n = data.shape[-1]
    if n % block_n:
        raise ValueError(f"N = {n} is not a multiple of block_n = {block_n}")
    if data.device.type == "cpu":
        return xor_rows_plain(data)
    check_cuda_operands(block_n, "block_n", data)
    out = torch.empty((*data.shape[:-2], n), dtype=torch.uint8, device=data.device)
    stream = raw_stream(data.device)
    if batched:
        b, t, _ = data.shape
        _build.launch("xor_parity_batched", data.data_ptr(), out.data_ptr(), b, t, n,
                      block_n, stream)
    else:
        _build.launch("xor_parity", data.data_ptr(), out.data_ptr(), data.shape[0], n,
                      block_n, stream)
    return out


def xor_parity(data: torch.Tensor, *, block_n: int = DEFAULT_BLOCK_N) -> torch.Tensor:
    """K7: data (T, N) uint8 -> (N,) XOR of rows; N % block_n == 0. On the
    card ``block_n`` is the bytes one thread block covers. Replaces
    src/repro/kernels/xor_parity.py ``xor_parity``."""
    return _launch(data, block_n, batched=False)


def xor_parity_batched(data: torch.Tensor, *, block_n: int = DEFAULT_BLOCK_N) -> torch.Tensor:
    """K7 batched: data (B, T, N) uint8 -> (B, N), B independent vertical
    repairs in one launch (the bucketed coalescer's "V" path). Replaces
    src/repro/kernels/xor_parity.py ``xor_parity_batched``."""
    return _launch(data, block_n, batched=True)
