"""GF(2^8) coefficient bit-plane expansion shared by the tile kernels.

Every GF kernel takes its coefficients as bit-planes:

    gfmul(c, x) = XOR_{b=0..7} ((x >> b) & 1) * gfmul(c, 2^b)

so the 8 constants gfmul(c, 2^b) per coefficient are precomputed
host-side and the kernel body is shifts, masks and XORs — no tables.
The single-op matrix kernel of the reference package
(``gf256_matmul_planes``) is not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

from repro_torch.coding import gf256


def expand_coeff_bitplanes(coef: np.ndarray) -> np.ndarray:
    """(M, K) uint8 coefficient matrix -> (M, K, 8) bit-plane constants
    Mc[i, k, b] = gfmul(coef[i, k], 2^b). Host-side, tiny."""
    coef = np.asarray(coef, dtype=np.uint8)
    planes = np.stack(
        [gf256._MUL_NP[coef, 1 << b] for b in range(8)], axis=-1
    )  # (M, K, 8)
    return planes.astype(np.uint8)
