"""Ragged decode tile kernels (K1, K2) and the tile contract.

The gateway's decode hot path is a WINDOW of reconstructions with mixed
shapes — horizontal RS decodes of varying target counts, vertical XOR
repairs, ragged byte lengths. The coalescer (gateway/coalescer.py) cuts
every decode ROW (one output row of one op) into fixed-width tiles,
gathers the tiles into a flat staging buffer, and one kernel launch per
chunk walks the tiles, applying each tile's own coefficient row.

Descriptor layout (built host-side by gateway/coalescer.py):

  * ``data``  (C, K, TN) u8 — tile t's K source slabs.  A row of length
    L occupies ceil(L / TN) consecutive tiles; the tail tile is
    zero-padded past its valid length (zero bytes contribute zero to
    both GF(256) products and XOR, so no in-kernel masking is needed —
    the host slices the valid prefix back out).  Ops with fewer than K
    sources zero-pad the K axis (a zero row is the identity for both
    ops).
  * ``mc``    (C, K, 8) u8 — tile t's coefficient row, bit-plane
    expanded (gf256_matmul.expand_coeff_bitplanes); the GF kernel only.
  * ``out``   (C, TN) u8 — tile t's output slab.

The launch tile count C is drawn from exactly two rungs (``CHUNK_SMALL``,
``CHUNK_BIG``): a window with T tiles issues T // CHUNK_BIG big launches
plus ceil(rem / CHUNK_SMALL) small ones, the last padded with null
tiles. These values fix launch counts and billing, and are the reference
package's.

The kernels are CUDA C++ (``csrc/ragged_tiles.cu``, see its header for
the design and what bounds it); each wrapper launches the kernel for a
CUDA tensor and runs the plain torch version beside it for a CPU tensor.
The CUDA path never falls back: a refused launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.backend import check_cuda_operands, raw_stream, reject_dtensor

# Launch-size rungs, in tiles. Two rungs bound the launch signatures per
# kind at 2 while keeping null-tile padding under CHUNK_SMALL per window
# (a window with T tiles issues T // CHUNK_BIG big launches, then small
# ones for the remainder).
CHUNK_SMALL = 4
CHUNK_BIG = 32

# Default tile width in bytes (callers cap it to the longest row staged).
DEFAULT_TILE_N = 4096


def chunk_sizes(num_tiles: int) -> list[int]:
    """Launch sizes covering ``num_tiles`` tiles from the two rungs:
    big chunks while they fit, then small ones (the last padded with
    null tiles). Total padding < CHUNK_SMALL."""
    assert num_tiles > 0, num_tiles
    chunks = [CHUNK_BIG] * (num_tiles // CHUNK_BIG)
    rem = num_tiles - CHUNK_BIG * len(chunks)
    chunks += [CHUNK_SMALL] * (-(-rem // CHUNK_SMALL))
    return chunks


# -- plain torch versions (the CPU path and the kernels' yardstick) ---------

def gf_tiles_plain(mc: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """out[c, j] = XOR_{k,b} ((data[c,k,j] >> b) & 1) * mc[c,k,b]."""
    c, kk, tn = data.shape
    out = torch.zeros((c, tn), dtype=torch.uint8, device=data.device)
    for k in range(kk):
        x = data[:, k, :]
        for b in range(8):
            bits = torch.bitwise_and(torch.bitwise_right_shift(x, b), 1)
            out ^= bits * mc[:, k, b : b + 1]
    return out


def xor_tiles_plain(data: torch.Tensor) -> torch.Tensor:
    """out[c] = XOR_k data[c, k]."""
    out = data[:, 0, :].clone()
    for k in range(1, data.shape[1]):
        out ^= data[:, k, :]
    return out


# -- launch helpers shared with ragged_encode --------------------------------
# Every check runs once per call: the tile contract first (any device),
# then, for a tensor not on the CPU, what the CUDA bodies take.

def _check(data: torch.Tensor, mc: torch.Tensor | None) -> torch.Size:
    """The tile contract on any device; returns data's (C, K, TN)."""
    shape = data.shape
    if data.dtype != torch.uint8 or len(shape) != 3:
        raise ValueError(f"data must be (C, K, TN) uint8, got {data.dtype} {tuple(shape)}")
    c, kk, _tn = shape
    if c == 0 or kk == 0:
        raise ValueError(f"empty tile set {tuple(shape)}")
    if mc is not None:
        if mc.dtype != torch.uint8 or mc.shape != (c, kk, 8):
            raise ValueError(f"mc must be (C, K, 8) uint8, got {tuple(mc.shape)}")
        if mc.device != data.device:
            raise ValueError(f"mc on {mc.device}, data on {data.device}")
    return shape


def _check_cuda(data: torch.Tensor, mc: torch.Tensor | None, tn: int) -> None:
    """``check_cuda_operands`` for the tiles, and ``mc`` 8-byte aligned:
    the GF body reads a tile's (k, 8) planes as one 8-byte word."""
    if mc is None:
        check_cuda_operands(tn, "tile width", data)
        return
    check_cuda_operands(tn, "tile width", data, mc)
    if mc.data_ptr() % 8:
        raise ValueError("mc must be 8-byte aligned for its plane loads")


def launch_gf(entry: str, mc: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    reject_dtensor(entry, mc, data)
    c, kk, tn = _check(data, mc)
    if data.device.type == "cpu":
        return gf_tiles_plain(mc, data)
    _check_cuda(data, mc, tn)
    out = data.new_empty((c, tn))
    _build.launch(entry, mc.data_ptr(), data.data_ptr(), out.data_ptr(), c, kk, tn,
                  raw_stream(data.device))
    return out


def launch_xor(entry: str, data: torch.Tensor) -> torch.Tensor:
    reject_dtensor(entry, data)
    c, kk, tn = _check(data, None)
    if data.device.type == "cpu":
        return xor_tiles_plain(data)
    _check_cuda(data, None, tn)
    out = data.new_empty((c, tn))
    _build.launch(entry, data.data_ptr(), out.data_ptr(), c, kk, tn, raw_stream(data.device))
    return out


# -- K1 / K2 -------------------------------------------------------------------

def ragged_gf256_tiles(mc: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """K1: one launch over C tiles of mixed GF(256) decode ops.
    mc (C, K, 8) per-tile coefficient bit-planes, data (C, K, TN) source
    tiles -> (C, TN). Replaces src/repro/kernels/ragged_decode.py
    ``ragged_gf256_tiles``."""
    return launch_gf("ragged_gf256_tiles", mc, data)


def ragged_xor_tiles(data: torch.Tensor) -> torch.Tensor:
    """K2: one launch over C tiles of mixed XOR repairs: data (C, K, TN)
    -> (C, TN). Replaces src/repro/kernels/ragged_decode.py
    ``ragged_xor_tiles``."""
    return launch_xor("ragged_xor_tiles", data)
