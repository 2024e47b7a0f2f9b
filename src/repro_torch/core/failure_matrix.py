"""Failure-matrix representation + independent-cluster identification (§6.1).

A failure matrix is a boolean (t+1, n) array: True = block lost. Two
failures belong to the same *independent cluster* iff they share a row or
a column (transitively). Clusters can be repaired in parallel and may
allow partial recovery of an otherwise-unrecoverable matrix.
"""

from __future__ import annotations

import numpy as np


def independent_clusters(fm: np.ndarray) -> list[np.ndarray]:
    """Split a failure matrix into independent clusters.

    Returns a list of boolean matrices, one per cluster, each the same
    shape as ``fm`` with only that cluster's failures set. Union-find over
    failure cells, merging on shared row or column.
    """
    fm = np.asarray(fm, dtype=bool)
    cells = np.argwhere(fm)
    if cells.shape[0] == 0:
        return []
    parent = list(range(cells.shape[0]))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    by_row: dict[int, int] = {}
    by_col: dict[int, int] = {}
    for idx, (r, c) in enumerate(cells):
        if r in by_row:
            union(idx, by_row[r])
        else:
            by_row[r] = idx
        if c in by_col:
            union(idx, by_col[c])
        else:
            by_col[c] = idx

    groups: dict[int, list[int]] = {}
    for idx in range(cells.shape[0]):
        groups.setdefault(find(idx), []).append(idx)

    out = []
    for members in groups.values():
        m = np.zeros_like(fm)
        for idx in members:
            r, c = cells[idx]
            m[r, c] = True
        out.append(m)
    return out


def num_clusters(fm: np.ndarray) -> int:
    return len(independent_clusters(fm))


def random_failure_matrix(
    rows: int, cols: int, num_failures: int, rng: np.random.Generator
) -> np.ndarray:
    """Uniformly random failure pattern with exactly ``num_failures`` cells."""
    fm = np.zeros(rows * cols, dtype=bool)
    idx = rng.choice(rows * cols, size=num_failures, replace=False)
    fm[idx] = True
    return fm.reshape(rows, cols)


# Canonical example patterns from §6.3 (row/col offsets are irrelevant:
# swapping rows/columns yields equivalent patterns).
def step_pattern(rows: int, cols: int) -> np.ndarray:
    """3-failure step: X at (r, c); X X at (r+1, c), (r+1, c+1)."""
    fm = np.zeros((rows, cols), dtype=bool)
    fm[1, 0] = True
    fm[2, 0] = True
    fm[2, 1] = True
    return fm


def plus_pattern(rows: int, cols: int) -> np.ndarray:
    """5-failure plus: vertical bar of 3 in one column crossing a
    horizontal bar of 3 in one row."""
    fm = np.zeros((rows, cols), dtype=bool)
    fm[1, 1] = True
    fm[2, 0] = True
    fm[2, 1] = True
    fm[2, 2] = True
    fm[3, 1] = True
    return fm
