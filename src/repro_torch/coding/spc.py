"""(t+1, t) single parity check code — the paper's *vertical* code.

Over the binary extension field the parity symbol is the XOR of the t
message symbols; any single erasure is repaired by XORing the surviving t.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.coding import gf256
from repro_torch.coding.linear import LinearCode


@functools.lru_cache(maxsize=None)
def make_spc(t: int) -> LinearCode:
    gen = np.concatenate(
        [np.eye(t, dtype=np.uint8), np.ones((1, t), dtype=np.uint8)], axis=0
    )
    return LinearCode(gen=gen)


def parity(blocks: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """XOR parity over ``axis`` of a stack of t blocks."""
    return gf256.xor_reduce(blocks, axis=axis)


def repair(surviving: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Repair the single missing symbol: XOR of the surviving t blocks
    (which may include the parity row itself)."""
    return gf256.xor_reduce(surviving, axis=axis)
