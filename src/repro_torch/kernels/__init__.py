# The erasure-coding dataplane's kernels, written in CUDA C++ for Hopper:
# the ragged tile kernels (csrc/ragged_tiles.cu — a GF(256) product of one
# coefficient row with K source slabs per tile, and a K-way XOR per tile)
# and the single-op / batched matrix kernels (csrc/gf_matmul_xor.cu —
# C (M, N) = coef (M, K) x data (K, N) over GF(2^8), and XOR over rows).
# Two dataplane generations ride them:
#
#   * shape-bucketed stacked launches — gf256_matmul_batched /
#     xor_parity_batched: one launch per (kind, M, K, blocklen) bucket,
#     batch sizes padded up a power-of-two ladder;
#   * the ragged tile dataplane — gf256_ragged / xor_ragged
#     (kernels/ragged_decode.py): a whole mixed-shape window staged as
#     fixed-width tiles with per-tile coefficient planes.
#
# kernels/autotune.py measures block_n / tile width per device at first
# use and persists the winners across processes. Importing this package
# builds and loads nothing (kernels/_build.py does, at first launch).
from repro_torch.kernels import autotune, ops, ragged_decode, ref
from repro_torch.kernels.ops import (
    gf256_matmul,
    gf256_matmul_batched,
    gf256_ragged,
    rs_decode,
    rs_encode,
    xor_parity,
    xor_parity_batched,
    xor_ragged,
)

__all__ = [
    "autotune",
    "ops",
    "ragged_decode",
    "ref",
    "gf256_matmul",
    "gf256_matmul_batched",
    "gf256_ragged",
    "rs_decode",
    "rs_encode",
    "xor_parity",
    "xor_parity_batched",
    "xor_ragged",
]
