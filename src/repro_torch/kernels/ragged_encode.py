"""Ragged ENCODE tile kernels (K3, K4): the write-path mirror of
kernels/ragged_decode.py.

A batching window's PUT work is a mixed bag of GF(256) parity ENCODES
(the systematic RS parity rows of ``coding/rs.py`` — parities = P @
data, "EH" ops) and XOR-delta parity FOLDS (new_parity = stored ^
old_row ^ new_row with any number of folded contributions, "EV" ops).
Both are the SAME tile algebra as decode, so the CUDA kernel bodies are
shared (``csrc/ragged_tiles.cu``); only the entries differ, which keeps
encode launches separately countable from decode launches. Descriptor
layout, chunk rungs and the zero-padding-is-identity staging contract
are ragged_decode's.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ragged_decode import (  # noqa: F401  (re-exported contract)
    CHUNK_BIG,
    CHUNK_SMALL,
    DEFAULT_TILE_N,
    chunk_sizes,
    launch_gf,
    launch_xor,
)


def ragged_gf256_encode_tiles(mc: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """K3: one launch over C tiles of mixed GF(256) parity encodes: mc
    (C, K, 8) generator-row bit-planes, data (C, K, TN) source-data
    tiles -> (C, TN) parity tiles. Replaces
    src/repro/kernels/ragged_encode.py ``ragged_gf256_encode_tiles``."""
    return launch_gf("ragged_gf256_encode_tiles", mc, data)


def ragged_xor_encode_tiles(data: torch.Tensor) -> torch.Tensor:
    """K4: one launch over C tiles of XOR-delta parity folds: data
    (C, K, TN) -> (C, TN), XOR over K. Replaces
    src/repro/kernels/ragged_encode.py ``ragged_xor_encode_tiles``."""
    return launch_xor("ragged_xor_encode_tiles", data)
