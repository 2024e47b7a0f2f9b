"""(n, k) Local Reconstruction Code per the paper's §3.3 (Azure LRC).

Composition of (i) a systematic global (n-2, k) MDS code contributing
m-2 = n-k-2 global parities and (ii) two local (k/2+1, k/2) single-parity
codes, one per half of the object.

Codeword layout (paper Fig. 2): [o_1, o_2, p_1, p_2, p_g]
  index 0 .. k/2-1   : first data half  (local group 0)
  index k/2 .. k-1   : second data half (local group 1)
  index k            : p_1 (XOR of group 0)
  index k+1          : p_2 (XOR of group 1)
  index k+2 .. n-1   : global parities
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from repro_torch.coding import rs
from repro_torch.coding.linear import LinearCode


@functools.lru_cache(maxsize=None)
def generator_matrix(n: int, k: int) -> np.ndarray:
    if k % 2 != 0:
        raise ValueError("LRC requires even k")
    if n < k + 2:
        raise ValueError("LRC requires n >= k + 2")
    half = k // 2
    gen = np.zeros((n, k), dtype=np.uint8)
    gen[:k] = np.eye(k, dtype=np.uint8)
    gen[k, :half] = 1  # p_1
    gen[k + 1, half:] = 1  # p_2
    if n > k + 2:
        gen[k + 2 :] = rs.parity_matrix(n - 2, k)  # global parities
    return gen


@functools.lru_cache(maxsize=None)
def make_lrc(n: int, k: int) -> "LRC":
    return LRC(gen=generator_matrix(n, k))


@dataclass(frozen=True)
class LRC(LinearCode):
    """LinearCode plus LRC-specific locality metadata and repair planning."""

    def local_group(self, i: int) -> list[int] | None:
        """Blocks participating in i's local parity equation (incl. i),
        or None for global parities (no locality)."""
        half = self.k // 2
        if i < half or i == self.k:
            return list(range(half)) + [self.k]
        if i < self.k or i == self.k + 1:
            return list(range(half, self.k)) + [self.k + 1]
        return None

    def repair_plan(
        self, failed: set[int]
    ) -> list[tuple[str, list[int], list[int]]] | None:
        """Greedy local-first repair plan.

        Returns a list of steps ``(kind, sources, repaired)`` where kind is
        'local' (XOR of k/2 sources) or 'global' (full decode from k
        sources), or None if the pattern is unrecoverable.
        """
        failed = set(failed)
        steps: list[tuple[str, list[int], list[int]]] = []
        while failed:
            progressed = False
            for i in sorted(failed):
                grp = self.local_group(i)
                if grp is None:
                    continue
                missing_in_grp = [g for g in grp if g in failed]
                if len(missing_in_grp) == 1:
                    sources = [g for g in grp if g not in failed]
                    steps.append(("local", sources, [i]))
                    failed.discard(i)
                    progressed = True
                    break
            if progressed:
                continue
            # fall back to one global decode repairing everything at once
            available = [i for i in range(self.n) if i not in failed]
            if not self.decodable(np.asarray(available)):
                return None
            row_ids, _ = self.decode_matrix(np.asarray(available))
            steps.append(("global", [int(r) for r in row_ids], sorted(failed)))
            failed = set()
        return steps

    @staticmethod
    def plan_traffic(steps: list[tuple[str, list[int], list[int]]]) -> int:
        """Number of block transfers implied by a repair plan."""
        return sum(len(src) for _, src, _ in steps)


def avg_single_repair_cost(n: int, k: int) -> float:
    """Paper §3.3: (2kn - k^2 - 2k) / 2n blocks on average."""
    return (2 * k * n - k * k - 2 * k) / (2 * n)
