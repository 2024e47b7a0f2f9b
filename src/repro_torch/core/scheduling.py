"""Repair scheduling algorithms (paper §6.3).

Three schedulers over a CORE failure matrix:
  * row-first      — prefer horizontal (RS) repairs
  * column-first   — prefer vertical (XOR) repairs
  * RGS            — Recursively Generated Schedule, driven by the
                     critical-failure potentials (v, h)

Cost accounting follows Table 1: a vertical repair reads t blocks, a
horizontal repair reads k blocks (and fixes every failure in its row).

Each step records its source cells so the storage layer can execute the
schedule verbatim and so the dependency structure (steps consuming
freshly-repaired blocks) is explicit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.product_code import CoreCode


@dataclass(frozen=True)
class RepairStep:
    kind: str  # 'V' (vertical XOR) or 'H' (horizontal RS)
    index: int  # column for V, row for H
    repairs: tuple[tuple[int, int], ...]  # cells fixed by this step
    sources: tuple[tuple[int, int], ...]  # cells read by this step

    @property
    def cost(self) -> int:
        return len(self.sources)


@dataclass
class Schedule:
    code: CoreCode
    steps: list[RepairStep] = field(default_factory=list)

    @property
    def traffic(self) -> int:
        """Total blocks read (paper's repair-cost metric)."""
        return sum(s.cost for s in self.steps)

    @property
    def num_vertical(self) -> int:
        return sum(1 for s in self.steps if s.kind == "V")

    @property
    def num_horizontal(self) -> int:
        return sum(1 for s in self.steps if s.kind == "H")

    def describe(self) -> str:
        return ",".join(f"{s.kind}{s.index}" for s in self.steps)


class _State:
    """Mutable failure matrix with helpers shared by all schedulers."""

    def __init__(self, code: CoreCode, fm: np.ndarray):
        self.code = code
        self.fm = np.asarray(fm, dtype=bool).copy()
        rows, cols = self.fm.shape
        if rows != code.t + 1 or cols != code.n:
            raise ValueError(f"failure matrix must be {(code.t + 1, code.n)}")

    @property
    def row_fail(self) -> np.ndarray:
        return self.fm.sum(axis=1)

    @property
    def col_fail(self) -> np.ndarray:
        return self.fm.sum(axis=0)

    def vertical_step(self, r: int, c: int) -> RepairStep:
        sources = tuple((rr, c) for rr in range(self.code.t + 1) if rr != r)
        self.fm[r, c] = False
        return RepairStep("V", int(c), ((int(r), int(c)),), sources)

    def horizontal_step(self, r: int) -> RepairStep:
        failed_cols = np.flatnonzero(self.fm[r])
        avail_cols = np.flatnonzero(~self.fm[r])[: self.code.k]
        sources = tuple((int(r), int(c)) for c in avail_cols)
        repairs = tuple((int(r), int(c)) for c in failed_cols)
        self.fm[r, failed_cols] = False
        return RepairStep("H", int(r), repairs, sources)

    def repairable_rows(self) -> np.ndarray:
        rf = self.row_fail
        return np.flatnonzero((rf > 0) & (rf <= self.code.m))

    def vertical_cells(self) -> list[tuple[int, int]]:
        """Cells repairable vertically right now (their column has exactly
        one failure)."""
        cf = self.col_fail
        out = []
        for c in np.flatnonzero(cf == 1):
            r = int(np.flatnonzero(self.fm[:, c])[0])
            out.append((r, int(c)))
        return out


def schedule_column_first(code: CoreCode, fm: np.ndarray) -> Schedule | None:
    st = _State(code, fm)
    sched = Schedule(code)
    while st.fm.any():
        cells = st.vertical_cells()
        if cells:
            for r, c in cells:
                if st.fm[r, c]:  # may have been cleared by an earlier V
                    sched.steps.append(st.vertical_step(r, c))
            continue
        rows = st.repairable_rows()
        if rows.size == 0:
            return None
        rf = st.row_fail
        best = rows[np.argmax(rf[rows])]  # max failures, ties -> lowest idx
        sched.steps.append(st.horizontal_step(int(best)))
    return sched


def schedule_row_first(code: CoreCode, fm: np.ndarray) -> Schedule | None:
    st = _State(code, fm)
    sched = Schedule(code)
    while st.fm.any():
        rows = st.repairable_rows()
        if rows.size > 0:
            rf = st.row_fail
            best = rows[np.argmax(rf[rows])]
            sched.steps.append(st.horizontal_step(int(best)))
            continue
        cells = st.vertical_cells()
        if not cells:
            return None
        r, c = cells[0]  # a single vertical repair, then retry horizontal
        sched.steps.append(st.vertical_step(r, c))
    return sched


def schedule_rgs(code: CoreCode, fm: np.ndarray) -> Schedule | None:
    """Recursively Generated Schedule.

    Critical potentials: v = sum_i max(0, rowfail_i - (n-k)) — the minimum
    number of vertical repairs forced by over-full rows; h = sum_j
    max(0, colfail_j - 1) — the minimum number of horizontal repairs
    forced by over-full columns. Critical repairs (those that decrement v
    then h) are emitted first along the recursion c(h, v); remaining
    repairs at the base case c(0, 0) are chosen by the static cost
    function c'(r) = min(k, r * t) per row.
    """
    st = _State(code, fm)
    sched = Schedule(code)
    mm = code.m
    while st.fm.any():
        rf, cf = st.row_fail, st.col_fail
        v = int(np.maximum(rf - mm, 0).sum())
        h = int(np.maximum(cf - 1, 0).sum())
        if v > 0:
            # vertical repair inside an over-full row, column must be free
            cand = [
                (r, c)
                for r in np.flatnonzero(rf > mm)
                for c in np.flatnonzero(st.fm[r])
                if cf[c] == 1
            ]
            if cand:
                r, c = cand[0]
                sched.steps.append(st.vertical_step(int(r), int(c)))
                continue
            # dec(v) not applicable -> fall through to a horizontal repair
        if h > 0 or v > 0:
            rows = st.repairable_rows()
            if rows.size > 0:
                # maximize h-decrease; tie-break on row failure count
                def h_gain(r: int) -> int:
                    return int(sum(1 for c in np.flatnonzero(st.fm[r]) if cf[c] >= 2))

                gains = np.asarray([h_gain(int(r)) for r in rows])
                best_mask = gains == gains.max()
                cand_rows = rows[best_mask]
                best = cand_rows[np.argmax(rf[cand_rows])]
                sched.steps.append(st.horizontal_step(int(best)))
                continue
            cells = st.vertical_cells()
            if not cells:
                return None
            r, c = cells[0]
            sched.steps.append(st.vertical_step(r, c))
            continue
        # base case c(0,0): each row independently, static cost c'
        for r in np.flatnonzero(rf > 0):
            r_i = int(rf[r])
            if code.k < r_i * code.t:
                sched.steps.append(st.horizontal_step(int(r)))
            else:
                for c in np.flatnonzero(st.fm[r]):
                    sched.steps.append(st.vertical_step(int(r), int(c)))
    return sched


SCHEDULERS = {
    "row_first": schedule_row_first,
    "column_first": schedule_column_first,
    "rgs": schedule_rgs,
}
