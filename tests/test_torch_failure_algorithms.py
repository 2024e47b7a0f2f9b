"""The port's §6 failure algorithms (clustering, recoverability, the three
repair schedulers) and their execution on the codec, against the JAX
package's: the cases of tests/test_failure_algorithms.py run on both
packages over the same failure matrices, with equal clusters, verdicts,
bounds and schedules step for step, and schedule execution restoring
the same bytes (the port's codec on ``device="cpu"``). Table 1's costs
for the (14, 12, 5) code are asserted exactly, as in the reference."""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.coding.linear as jlin  # noqa: E402
import repro.coding.rs as jrs  # noqa: E402
import repro.core as jc  # noqa: E402
import repro_torch.coding.linear as tlin  # noqa: E402
import repro_torch.coding.rs as trs  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import torch  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves, and the
    suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROWS, COLS = 6, 14
JCODE, TCODE = jc.CoreCode(14, 12, 5), tc.CoreCode(14, 12, 5)
SCHEDULERS = ("schedule_row_first", "schedule_column_first", "schedule_rgs")


def _clusters(mod, fm):
    return [c.tolist() for c in mod.independent_clusters(fm)], mod.num_clusters(fm)


def _sched(mod, code, name, fm):
    s = getattr(mod, name)(code, fm)
    if s is None:
        return None
    return s.traffic, [(st_.kind, st_.index, tuple(st_.repairs), tuple(st_.sources))
                       for st_ in s.steps]


def test_patterns_and_bounds_equal():
    for fn in ("step_pattern", "plus_pattern"):
        assert np.array_equal(getattr(tc, fn)(ROWS, COLS), getattr(jc, fn)(ROWS, COLS))
    assert tc.irrecoverability_lower_bound(TCODE) == jc.irrecoverability_lower_bound(JCODE) == 6
    assert tc.recoverability_upper_bound(TCODE) == jc.recoverability_upper_bound(JCODE) == 20


def _hand_patterns():
    out = {}
    fm = np.zeros((ROWS, COLS), dtype=bool)
    fm[0, 0] = fm[2, 5] = fm[4, 9] = True
    out["disjoint"] = fm
    fm = np.zeros((ROWS, COLS), dtype=bool)
    fm[0, 0] = fm[0, 5] = fm[3, 5] = fm[3, 9] = fm[1, 2] = True
    out["merged"] = fm
    fm = np.zeros((ROWS, COLS), dtype=bool)
    fm[:, :2] = True
    for r in range(ROWS):
        fm[r, 2 + 2 * r] = fm[r, 3 + 2 * r] = True
    out["counterexample_24"] = fm
    fm = np.zeros((ROWS, COLS), dtype=bool)
    fm[0, :3] = fm[1, :3] = True
    out["irrecoverable_at_lower"] = fm
    fm = np.zeros((ROWS, COLS), dtype=bool)
    fm[:5, :2] = True
    fm[5, 2:12] = True
    out["recoverable_at_upper"] = fm
    out["step"] = tc.step_pattern(ROWS, COLS)
    out["plus"] = tc.plus_pattern(ROWS, COLS)
    return out


PATTERNS = _hand_patterns()
EXPECT = {"disjoint": (3, True), "merged": (2, True), "counterexample_24": (None, True),
          "irrecoverable_at_lower": (None, False), "recoverable_at_upper": (None, True),
          "step": (None, True), "plus": (None, True)}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_hand_patterns_equal(name):
    fm = PATTERNS[name]
    assert _clusters(tc, fm) == _clusters(jc, fm)
    ok = bool(tc.is_recoverable(TCODE, fm))
    assert ok == bool(jc.is_recoverable(JCODE, fm)) == EXPECT[name][1]
    nf = int(fm.sum())
    assert tc.fast_classify(TCODE, nf) == jc.fast_classify(JCODE, nf)
    for sched in SCHEDULERS:
        port = _sched(tc, TCODE, sched, fm)
        assert port == _sched(jc, JCODE, sched, fm), sched
        assert (port is None) == (not ok)
    if EXPECT[name][0] is not None:
        assert _clusters(tc, fm)[1] == EXPECT[name][0]
    clusters = tc.independent_clusters(fm)
    if clusters:
        assert np.array_equal(sum(c.astype(int) for c in clusters), fm.astype(int))


def test_table1_costs_exact():
    k, t = 12, 5
    step, plus = PATTERNS["step"], PATTERNS["plus"]
    assert [_sched(tc, TCODE, s, step)[0] for s in SCHEDULERS] == [2 * k, 2 * t + k, k + t]
    assert [_sched(tc, TCODE, s, plus)[0] for s in SCHEDULERS] == [
        3 * k + t, 3 * t + 2 * k, 2 * t + 2 * k]
    assert [[k_ for k_, *_ in _sched(tc, TCODE, s, step)[1]] for s in SCHEDULERS] == [
        ["H", "H"], ["V", "H", "V"], ["H", "V"]]


def _random_sweep(mod, code, seed, lo, hi, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        nf = int(rng.integers(lo, hi))
        fm = mod.random_failure_matrix(ROWS, COLS, nf, rng)
        out.append((fm.tolist(), bool(mod.is_recoverable(code, fm)), mod.num_clusters(fm)))
    return out


@pytest.mark.parametrize("seed,lo,hi,n", [(0, 1, 21, 20), (1, 1, 6, 300), (2, 21, 85, 300)],
                         ids=["cluster-bounds", "below-lower", "above-upper"])
def test_random_sweeps_equal(seed, lo, hi, n):
    port = _random_sweep(tc, TCODE, seed, lo, hi, n)
    assert port == _random_sweep(jc, JCODE, seed, lo, hi, n)
    if seed == 0:
        for fm, _ok, nc in port:
            assert 1 <= nc <= min(int(np.sum(fm)), ROWS)
    elif seed == 1:
        assert all(ok for _fm, ok, _nc in port)
    else:
        assert sum(ok for _fm, ok, _nc in port) / n < 0.05


def _rank_check(lin, rs_mod, core):
    code = core.CoreCode(n=5, k=3, t=2)
    g_h = rs_mod.generator_matrix(code.n, code.k)
    g_v = np.concatenate([np.eye(code.t, dtype=np.uint8), np.ones((1, code.t), dtype=np.uint8)])
    full = lin.LinearCode(gen=np.kron(g_v, g_h))
    cells = [(r, c) for r in range(code.t + 1) for c in range(code.n)]
    rng = np.random.default_rng(3)
    out = []
    for nf in range(1, 9):
        for _ in range(60):
            idx = rng.choice(len(cells), size=nf, replace=False)
            fm = np.zeros((code.t + 1, code.n), dtype=bool)
            for i in idx:
                fm[cells[i]] = True
            avail = [r * code.n + c for r in range(code.t + 1) for c in range(code.n)
                     if not fm[r, c]]
            out.append((bool(full.decodable(np.asarray(avail))),
                        bool(core.is_recoverable(code, fm))))
    return out


def test_recoverability_vs_exhaustive_rank_check():
    port = _rank_check(tlin, trs, tc)
    assert port == _rank_check(jlin, jrs, jc)
    assert all(exact for exact, rec in port if rec)
    misses = [exact for exact, rec in port if not rec]
    if misses:
        assert sum(misses) / len(misses) < 0.35


@settings(max_examples=60, deadline=None)
@given(st.integers(min_value=1, max_value=12), st.integers(min_value=0, max_value=10**6))
def test_schedules_equal_fix_everything_and_rgs_never_worse(nf, seed):
    fm = tc.random_failure_matrix(ROWS, COLS, nf, np.random.default_rng(seed))
    assert np.array_equal(fm, jc.random_failure_matrix(ROWS, COLS, nf,
                                                       np.random.default_rng(seed)))
    scheds = {s: _sched(tc, TCODE, s, fm) for s in SCHEDULERS}
    assert scheds == {s: _sched(jc, JCODE, s, fm) for s in SCHEDULERS}
    if not tc.is_recoverable(TCODE, fm):
        return
    for name, s in scheds.items():
        assert s is not None, name
        fixed = {cell for step in s[1] for cell in step[2]}
        assert fixed == {tuple(c) for c in np.argwhere(fm)}, name
    traffic = {name: s[0] for name, s in scheds.items()}
    assert traffic["schedule_rgs"] <= traffic["schedule_row_first"]
    assert traffic["schedule_rgs"] <= traffic["schedule_column_first"] + 12


def _execute(core, dev, pattern, scheduler):
    code = core.CoreCode(n=9, k=6, t=3)
    codec = core.CoreCodec(code, **dev)
    rng = np.random.default_rng(11)
    objects = rng.integers(0, 256, size=(code.t, code.k, 40), dtype=np.uint8)
    matrix = np.asarray(codec.encode(objects))
    fm = getattr(core, pattern)(code.t + 1, code.n)
    store = {(r, c): matrix[r, c] for r in range(code.t + 1) for c in range(code.n)
             if not fm[r, c]}
    for step in getattr(core, scheduler)(code, fm).steps:
        assert all(src in store for src in step.sources), "read a missing block"
        stack = np.stack([store[s] for s in step.sources])
        if step.kind == "V":
            ((r, c),) = step.repairs
            store[(r, c)] = np.asarray(codec.repair_vertical(stack))
        else:
            avail = np.asarray([c for (_, c) in step.sources])
            missing = np.asarray([c for (_, c) in step.repairs])
            rep = np.asarray(codec.repair_horizontal(stack, avail, missing))
            for i, (_, c) in enumerate(step.repairs):
                store[(step.index, c)] = rep[i]
    return matrix, store


@pytest.mark.parametrize("pattern", ["step_pattern", "plus_pattern"])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_schedule_executes_to_the_reference_blocks(pattern, scheduler):
    jm, js = _execute(jc, {}, pattern, scheduler)
    tm, ts = _execute(tc, {"device": "cpu"}, pattern, scheduler)
    assert np.array_equal(tm, jm)
    assert sorted(ts) == sorted(js)
    for key, blk in ts.items():
        assert np.array_equal(blk, js[key]) and np.array_equal(blk, tm[key]), key


def test_codec_encode_properties():
    rng = np.random.default_rng(12)
    objects = rng.integers(0, 256, size=(3, 6, 16), dtype=np.uint8)
    tcodec = tc.CoreCodec(tc.CoreCode(9, 6, 3), device="cpu")
    matrix = tcodec.encode(objects)
    assert tuple(matrix.shape) == (4, 9, 16) and tcodec.verify(matrix)
    ref = np.asarray(jc.CoreCodec(jc.CoreCode(9, 6, 3)).encode(objects))
    assert np.array_equal(matrix.numpy(), ref)
    assert tc.CoreCode(9, 6, 3).stretch == jc.CoreCode(9, 6, 3).stretch == 2.0
