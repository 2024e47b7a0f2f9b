"""The CORE (n, k, t) product code, worked out from its definition.

Rows 0..t-1 of a group are t objects, each a systematic RS(n, k)
codeword; row t is the XOR of the t rows, column by column. The RS
generator is the one the configuration names: the n x k Vandermonde
matrix V[i, j] = a_i^j over the points a_i = 1..n, made systematic as
V @ inv(V[:k]), so its first k rows are the identity and the parity rows
P = G[k:] give the n - k parity blocks of a row as P @ data.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import gf256


class CoreCode:
    def __init__(self, n: int, k: int, t: int, field_poly: int):
        self.n, self.k, self.t, self.poly = n, k, t, field_poly
        vand = np.array(
            [[gf256.power(i + 1, j, field_poly) for j in range(k)] for i in range(n)],
            dtype=np.uint8,
        )
        gen = gf256.mat_mul(vand, gf256.mat_inv(vand[:k], field_poly), field_poly)
        if not np.array_equal(gen[:k], np.eye(k, dtype=np.uint8)):
            raise ValueError("the RS generator is not systematic")
        self.parity = gen[k:]

    @classmethod
    def from_config(cls, code: dict) -> "CoreCode":
        return cls(code["n"], code["k"], code["t"], code["field_poly"])

    def encode_row(self, data: torch.Tensor) -> torch.Tensor:
        """(k, q) data blocks -> the (n, q) RS codeword row."""
        return torch.cat([data, gf256.combine(self.parity, data, self.poly)])

    def encode_group(self, objects: torch.Tensor) -> torch.Tensor:
        """(t, k, q) objects -> the (t + 1, n, q) CORE group matrix."""
        rows = torch.stack([self.encode_row(obj) for obj in objects])
        xor = rows[0].clone()
        for r in rows[1:]:
            xor ^= r
        return torch.cat([rows, xor[None]])
