"""Analytical + Monte-Carlo evaluation of CORE vs MDS vs LRC (paper §5).

All closed forms are from §5.1; the Monte-Carlo engines mirror §5.2/§5.3
("measured numerically using a Monte-Carlo experiment"). Traffic is
normalized by the object size (k blocks); repair time by the time to pull
a whole object from a single node (k block-times).

NOTE on the paper's π_C formula: the paper prints
``π_C >= Σ C(n,i) θ^i (1-θ)^{n-i}`` with θ = Pr(column has ≤1 failure);
as printed this sums the probability that at most m columns are *good*,
which is clearly a typo (it would vanish for small p). The intended
quantity is Pr(#bad columns ≤ m) with a column bad w.p. 1-θ, which is
what we implement: a good column vertically repairs its ≤1 missing block,
and with ≥ k fully-repaired columns every row decodes horizontally.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.coding import lrc as lrc_mod
from repro_torch.core.product_code import CoreCode
from repro_torch.core.recoverability import is_recoverable
from repro_torch.core.scheduling import schedule_rgs

# ---------------------------------------------------------------------------
# §5.1 static resilience (closed forms)
# ---------------------------------------------------------------------------


def _binom_pmf(n: int, i: int, p: float) -> float:
    return math.comb(n, i) * (p**i) * ((1.0 - p) ** (n - i))


def _binom_cdf(n: int, m: int, p: float) -> float:
    return sum(_binom_pmf(n, i, p) for i in range(0, m + 1))


def resilience_mds(n: int, k: int, p: float) -> float:
    """π_E = Pr(B(n,p) <= n-k)."""
    return _binom_cdf(n, n - k, p)


def resilience_lrc(n: int, k: int, p: float) -> float:
    """π_L per §5.1 (Pr of global-decodable plus the local-repair terms)."""
    m = n - k
    theta = (k / 2 + 1) * p * (1.0 - p) ** (k / 2)
    return (
        _binom_cdf(n, m - 2, p)
        + _binom_pmf(n, m - 1, p) * 2.0 * theta * (1.0 - theta)
        + _binom_pmf(n, m, p) * (1.0 - theta) ** 2
    )


def resilience_core_lower(n: int, k: int, t: int, p: float) -> float:
    """Lower bound on π_C: Pr(#bad columns <= n-k), bad = >1 failure in
    the (t+1)-block column. (Paper's formula with the typo corrected —
    see module docstring.)"""
    theta_good = (1.0 - p) ** (t + 1) + (t + 1) * p * (1.0 - p) ** t
    return _binom_cdf(n, n - k, 1.0 - theta_good)


def nines(pi: float) -> float:
    """π -> 'number of nines' = log10(1/(1-π)), capped for π == 1."""
    if pi >= 1.0:
        return float("inf")
    return math.log10(1.0 / (1.0 - pi))


# ---------------------------------------------------------------------------
# §5.2 Monte-Carlo repair traffic & repair time
# ---------------------------------------------------------------------------


@dataclass
class MCResult:
    mean_traffic: float  # E(W | Π), normalized by k blocks
    var_traffic: float  # Var(W | Π)
    mean_time: float  # E(T | Π), normalized by k block-times
    var_time: float
    resilience: float  # empirical Pr(Π)
    samples: int


def _simulate_makespan(steps: list, k: int) -> float:
    """Repair makespan under the §5.2 network model.

    Congestion-free fabric; each node has unit send/receive bandwidth of
    one block per block-time. Each step executes at a distinct receiver
    and must pull ``len(sources)`` blocks (receiver-bound: c block-times),
    and can only start after every source block exists. Source-node send
    contention is modeled by tracking a next-free time per source cell.
    Normalized by k block-times.
    """
    ready: dict[tuple[int, int], float] = {}
    send_free: dict[tuple[int, int], float] = {}
    makespan = 0.0
    for step in steps:
        start = 0.0
        for src in step.sources:
            start = max(start, ready.get(src, 0.0))
        # receiver pulls c blocks serially; sources also serialize sends
        finish = start
        for src in step.sources:
            s = max(finish if False else start, send_free.get(src, 0.0))
            send_free[src] = s + 1.0
        finish = start + len(step.sources)
        for cell in step.repairs:
            ready[cell] = finish
        makespan = max(makespan, finish)
    return makespan / k


def _ec_repair_steps(fm_row: np.ndarray, n: int, k: int) -> list:
    """Classic MDS repair of one object: one decode from k survivors
    fixes every failure in the row (Opt1+Opt2 semantics)."""
    from repro_torch.core.scheduling import RepairStep

    failed = np.flatnonzero(fm_row)
    avail = np.flatnonzero(~fm_row)[:k]
    return [
        RepairStep(
            "H",
            0,
            tuple((0, int(c)) for c in failed),
            tuple((0, int(c)) for c in avail),
        )
    ]


def mc_repair_mds(n: int, k: int, p: float, samples: int, seed: int = 0) -> MCResult:
    rng = np.random.default_rng(seed)
    traffics, times = [], []
    ok = 0
    for _ in range(samples):
        fm = rng.random(n) < p
        nf = int(fm.sum())
        if nf == 0:
            continue
        if nf > n - k:
            continue  # unrecoverable -> excluded by conditioning on Π
        ok += 1
        steps = _ec_repair_steps(fm, n, k)
        traffics.append(sum(len(s.sources) for s in steps) / k)
        times.append(_simulate_makespan(steps, k))
    return _finalize(traffics, times, ok, samples)


def mc_repair_lrc(n: int, k: int, p: float, samples: int, seed: int = 0) -> MCResult:
    code = lrc_mod.make_lrc(n, k)
    rng = np.random.default_rng(seed)
    traffics, times = [], []
    ok = 0
    for _ in range(samples):
        fm = rng.random(n) < p
        failed = set(int(i) for i in np.flatnonzero(fm))
        if not failed:
            continue
        plan = code.repair_plan(set(failed))
        if plan is None:
            continue
        ok += 1
        from repro_torch.core.scheduling import RepairStep

        steps = []
        for kind, sources, repaired in plan:
            steps.append(
                RepairStep(
                    "V" if kind == "local" else "H",
                    0,
                    tuple((0, int(r)) for r in repaired),
                    tuple((0, int(s)) for s in sources),
                )
            )
        traffics.append(sum(len(s.sources) for s in steps) / k)
        times.append(_simulate_makespan(steps, k))
    return _finalize(traffics, times, ok, samples)


def mc_repair_core(
    n: int, k: int, t: int, p: float, samples: int, seed: int = 0
) -> MCResult:
    code = CoreCode(n=n, k=k, t=t)
    rng = np.random.default_rng(seed)
    traffics, times = [], []
    ok = 0
    for _ in range(samples):
        fm = rng.random((t + 1, n)) < p
        nf = int(fm.sum())
        if nf == 0:
            continue
        if not is_recoverable(code, fm):
            continue
        sched = schedule_rgs(code, fm)
        assert sched is not None
        ok += 1
        affected = max(1, int((fm.sum(axis=1) > 0).sum()))
        traffics.append(sched.traffic / (k * affected))
        times.append(_simulate_makespan(sched.steps, k))
    return _finalize(traffics, times, ok, samples)


def _finalize(traffics, times, ok, samples) -> MCResult:
    if not traffics:
        return MCResult(0.0, 0.0, 0.0, 0.0, 0.0, samples)
    tr = np.asarray(traffics)
    tm = np.asarray(times)
    return MCResult(
        mean_traffic=float(tr.mean()),
        var_traffic=float(tr.var()),
        mean_time=float(tm.mean()),
        var_time=float(tm.var()),
        resilience=ok / samples,
        samples=samples,
    )


# ---------------------------------------------------------------------------
# §5.3 degraded reads
# ---------------------------------------------------------------------------


def degraded_read_mds(n: int, k: int, p: float, samples: int, seed: int = 0,
                      distributed: bool = False) -> float:
    """Normalized traffic to read one object under unavailability p.

    Centralized: the reader needs the whole object — k systematic reads if
    all available, else any-k decode (still k, + re-reads of what it
    already pulled are not double counted: decode subsumes the read).
    Distributed: k readers, one systematic block each; a reader whose
    block is missing pulls k blocks to decode it.
    """
    rng = np.random.default_rng(seed)
    total, cnt = 0.0, 0
    for _ in range(samples):
        fm = rng.random(n) < p
        if int(fm.sum()) > n - k:
            continue
        cnt += 1
        miss_sys = int(fm[:k].sum())
        if not distributed:
            total += k / k  # decode-or-read is k blocks either way
        else:
            total += ((k - miss_sys) + miss_sys * k) / k
    return total / max(cnt, 1)


def degraded_read_lrc(n: int, k: int, p: float, samples: int, seed: int = 0,
                      distributed: bool = False) -> float:
    code = lrc_mod.make_lrc(n, k)
    rng = np.random.default_rng(seed)
    total, cnt = 0.0, 0
    for _ in range(samples):
        fm = rng.random(n) < p
        failed = set(int(i) for i in np.flatnonzero(fm))
        miss_sys = [i for i in range(k) if i in failed]
        if failed and code.repair_plan(set(failed)) is None:
            continue
        cnt += 1
        if not distributed:
            if not miss_sys:
                total += 1.0
                continue
            # repair missing systematic blocks (local first), then read rest
            plan = code.repair_plan(set(failed))
            repair_traffic = 0
            covered: set[int] = set()
            for kind, sources, repaired in plan:
                if any(r in miss_sys for r in repaired) or kind == "global":
                    repair_traffic += len(sources)
                    covered.update(repaired)
                if all(ms in covered for ms in miss_sys):
                    break
            total += ((k - len(miss_sys)) + repair_traffic) / k
        else:
            tr = 0
            for i in range(k):
                if i not in failed:
                    tr += 1
                else:
                    grp = code.local_group(i)
                    if sum(1 for g in grp if g in failed) == 1:
                        tr += len(grp) - 1  # k/2 local reads
                    else:
                        tr += k  # global decode
            total += tr / k
    return total / max(cnt, 1)


def degraded_read_core(n: int, k: int, t: int, p: float, samples: int,
                       seed: int = 0, distributed: bool = False) -> float:
    code = CoreCode(n=n, k=k, t=t)
    rng = np.random.default_rng(seed)
    total, cnt = 0.0, 0
    for _ in range(samples):
        fm = rng.random((t + 1, n)) < p
        if not is_recoverable(code, fm):
            continue
        cnt += 1
        # read object = row 0 (w.l.o.g. — rows are exchangeable)
        row = 0
        miss_sys = [c for c in range(k) if fm[row, c]]
        if not distributed:
            if not miss_sys:
                total += 1.0
                continue
            tr = k - len(miss_sys)  # direct reads of the available blocks
            horiz_needed = False
            for c in miss_sys:
                if fm[:, c].sum() == 1:
                    tr += t  # vertical repair
                else:
                    horiz_needed = True
            if horiz_needed:
                # one horizontal decode replaces everything: k reads total
                tr = min(tr + k, 2 * k)
                tr = k if int(fm[row].sum()) <= n - k else tr
            total += tr / k
        else:
            tr = 0
            for c in range(k):
                if not fm[row, c]:
                    tr += 1
                elif fm[:, c].sum() == 1:
                    tr += t
                else:
                    tr += k  # degraded reader falls back to row decode
            total += tr / k
    return total / max(cnt, 1)


# ---------------------------------------------------------------------------
# parameter sweeps (§5.2 "for each stretch factor choose the best")
# ---------------------------------------------------------------------------


def core_params_for_stretch(stretch: float, tol: float = 0.08) -> list[tuple[int, int, int]]:
    """Enumerate (n, k, t) with stretch factor ~= requested."""
    out = []
    for k in range(2, 17):
        for n in range(k + 1, min(k + 7, 26)):
            for t in range(2, 11):
                s = (n * (t + 1)) / (k * t)
                if abs(s - stretch) <= tol:
                    out.append((n, k, t))
    return out


def ec_params_for_stretch(stretch: float, tol: float = 0.08) -> list[tuple[int, int]]:
    out = []
    for k in range(2, 17):
        for n in range(k + 1, min(k + 9, 26)):
            if abs(n / k - stretch) <= tol:
                out.append((n, k))
    return out


def lrc_params_for_stretch(stretch: float, tol: float = 0.08) -> list[tuple[int, int]]:
    out = []
    for k in range(2, 17, 2):
        for n in range(k + 2, min(k + 9, 26)):
            if abs(n / k - stretch) <= tol:
                out.append((n, k))
    return out
