"""Recoverability bounds + recursive checking algorithm (paper §6.2).

Bounds for a (n, k, t) CORE code:
  * lower bound of irrecoverability L = 2 (n - k + 1): two rows minimally
    irrecoverable with identical failure columns.
  * upper bound of recoverability U = t (n - k) + (2k - n): all t object
    rows maximally (horizontally) recoverable with identical failure
    columns, plus one failure in each of the remaining 2k - n columns.
Any pattern with < L failures is recoverable; the paper claims any with
> U is not. NOTE (documented deviation, see EXPERIMENTS.md
§Paper-validation): U is *not* a strict converse bound — e.g. for
(14,12,5), 12 singleton-column failures (vertically peelable) on top of
6 rows x 2 identical-column failures (horizontally repairable after the
peel) gives a recoverable 24-failure pattern > U = 20. Such patterns are
vanishingly rare under uniform sampling, which is why the paper's 10M-run
Fig. 10 stops at U. ``fast_classify`` therefore only short-circuits on
the sound direction (< L ⇒ recoverable); U is kept for reporting parity
with the paper.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.product_code import CoreCode


def irrecoverability_lower_bound(code: CoreCode) -> int:
    return 2 * (code.n - code.k + 1)


def recoverability_upper_bound(code: CoreCode) -> int:
    return code.t * (code.n - code.k) + (2 * code.k - code.n)


def is_recoverable(code: CoreCode, fm: np.ndarray) -> bool:
    """Recursive checker: repeatedly clear repairable rows (<= n-k
    failures) and repairable columns (<= 1 failure); recoverable iff the
    matrix empties out."""
    fm = np.asarray(fm, dtype=bool).copy()
    rows, cols = fm.shape
    if rows != code.t + 1 or cols != code.n:
        raise ValueError(f"failure matrix must be {(code.t + 1, code.n)}")
    m = code.n - code.k
    while fm.any():
        row_fail = fm.sum(axis=1)
        repairable_rows = (row_fail > 0) & (row_fail <= m)
        col_fail = fm.sum(axis=0)
        repairable_cols = col_fail == 1
        if not repairable_rows.any() and not repairable_cols.any():
            return False
        fm[repairable_rows, :] = False
        fm[:, repairable_cols] = False
    return True


def fast_classify(code: CoreCode, num_failures: int) -> bool | None:
    """Count-only short-circuit. Only the sound direction is used (< L ⇒
    recoverable); see the module docstring for why > U is not decided."""
    if num_failures < irrecoverability_lower_bound(code):
        return True
    return None
