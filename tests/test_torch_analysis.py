"""The port's closed-form and Monte-Carlo analysis
(``repro_torch.core.analysis``) against the JAX package's: the cases of
tests/test_analysis.py run on both, with equal closed forms and equal
``MCResult`` fields for the same seeds (tolerance 0), then the paper's
claims checked on the port's numbers."""

from __future__ import annotations

import dataclasses
import inspect

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core.analysis as ja  # noqa: E402
import repro_torch.core.analysis as ta  # noqa: E402
from repro.core.product_code import CoreCode as JCode  # noqa: E402
from repro_torch.core.product_code import CoreCode as TCode  # noqa: E402
import torch  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves, and the
    suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mc(res) -> dict:
    return dataclasses.asdict(res)


def test_port_defines_every_public_name():
    public = {n for n, v in vars(ja).items()
              if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
              and v.__module__ == ja.__name__}
    assert public <= set(vars(ta))
    for name in public:
        if inspect.isfunction(getattr(ja, name)):
            assert (inspect.signature(getattr(ta, name))
                    == inspect.signature(getattr(ja, name))), name
    assert [f.name for f in dataclasses.fields(ta.MCResult)] == [
        f.name for f in dataclasses.fields(ja.MCResult)]


CLOSED = [
    ("resilience_mds", (9, 6, 0.0)), ("resilience_mds", (9, 6, 1.0)),
    ("resilience_mds", (2, 1, 0.5)), ("resilience_mds", (9, 6, 0.1)),
    ("resilience_lrc", (10, 6, 0.01)), ("resilience_core_lower", (9, 6, 3, 0.08)),
    ("nines", (0.999,)), ("nines", (0.0,)), ("nines", (1.0,)),
] + [(fn, (14, 10, p)) for fn in ("resilience_lrc",) for p in (0.002, 0.005, 0.01, 0.02, 0.05)] \
  + [(fn, (14, 12, 5, p)) for fn in ("resilience_core_lower",)
     for p in (0.002, 0.005, 0.01, 0.02, 0.05)]


@pytest.mark.parametrize("name,args", CLOSED, ids=[f"{n}{a}" for n, a in CLOSED])
def test_closed_forms_equal(name, args):
    assert getattr(ta, name)(*args) == getattr(ja, name)(*args)


def test_resilience_edge_cases_and_nines():
    assert ta.resilience_mds(9, 6, 0.0) == pytest.approx(1.0)
    assert ta.resilience_mds(9, 6, 1.0) == pytest.approx(0.0)
    assert ta.resilience_mds(2, 1, 0.5) == pytest.approx(0.75)
    assert ta.nines(0.999) == pytest.approx(3.0, abs=1e-9)
    assert ta.nines(0.0) == pytest.approx(0.0)


def test_resilience_mds_matches_simulation():
    rng = np.random.default_rng(0)
    n, k, p = 9, 6, 0.1
    hits = sum(int((rng.random(n) < p).sum() <= n - k) for _ in range(20000))
    assert ta.resilience_mds(n, k, p) == pytest.approx(hits / 20000, abs=0.01)


def test_resilience_core_lower_is_lower_bound_vs_checker():
    from repro_torch.core.recoverability import is_recoverable

    code = TCode(9, 6, 3)
    rng = np.random.default_rng(1)
    p, n_samples = 0.08, 4000
    rec = sum(bool(is_recoverable(code, rng.random((code.t + 1, code.n)) < p))
              for _ in range(n_samples))
    assert ta.resilience_core_lower(code.n, code.k, code.t, p) <= rec / n_samples + 0.01


def test_fig4_ordering_core_beats_lrc_at_same_stretch():
    for p in (0.002, 0.005, 0.01, 0.02, 0.05):
        assert ta.resilience_core_lower(14, 12, 5, p) >= ta.resilience_lrc(14, 10, p) - 1e-12


# (function, args, keywords) of every Monte-Carlo call in the reference
MC = [
    ("mc_repair_core", (14, 12, 6), {"p": 0.004, "samples": 4000, "seed": 2}),
    ("mc_repair_mds", (14, 12), {"p": 0.004, "samples": 4000, "seed": 2}),
    ("mc_repair_core", (14, 12, 5), {"p": 0.01, "samples": 2000, "seed": 3}),
    ("mc_repair_mds", (14, 12), {"p": 0.01, "samples": 2000, "seed": 3}),
    ("mc_repair_lrc", (10, 6), {"p": 0.003, "samples": 6000, "seed": 4}),
]


@pytest.fixture(scope="module")
def mc_results():
    return {i: (getattr(ja, fn)(*args, **kw), getattr(ta, fn)(*args, **kw))
            for i, (fn, args, kw) in enumerate(MC)}


@pytest.mark.parametrize("i", range(len(MC)), ids=[f"{fn}{a}" for fn, a, _ in MC])
def test_mc_results_equal(mc_results, i):
    ref, port = mc_results[i]
    assert _mc(port) == _mc(ref)


def test_single_failure_traffic_claims(mc_results):
    core, mds = mc_results[0][1], mc_results[1][1]
    assert core.mean_traffic == pytest.approx(6 / 12, abs=0.05)
    assert mds.mean_traffic == pytest.approx(1.0, abs=0.01)
    assert core.mean_traffic < 0.62 * mds.mean_traffic


def test_repair_time_core_much_faster(mc_results):
    assert mc_results[2][1].mean_time < 0.7 * mc_results[3][1].mean_time


def test_lrc_single_repair_cost_average(mc_results):
    from repro_torch.coding.lrc import avg_single_repair_cost

    want = avg_single_repair_cost(10, 6) / 6
    assert mc_results[4][1].mean_traffic == pytest.approx(want, abs=0.06)


DEGRADED = [
    ("degraded_read_mds", (9, 6), {"p": 0.01, "samples": 3000, "seed": 5}),
    ("degraded_read_lrc", (10, 6), {"p": 0.01, "samples": 3000, "seed": 5}),
    ("degraded_read_core", (9, 6, 3), {"p": 0.01, "samples": 3000, "seed": 5}),
    ("degraded_read_mds", (9, 6), {"p": 0.1, "samples": 4000, "seed": 6, "distributed": True}),
    ("degraded_read_lrc", (10, 6), {"p": 0.1, "samples": 4000, "seed": 6, "distributed": True}),
    ("degraded_read_core", (9, 6, 3),
     {"p": 0.1, "samples": 4000, "seed": 6, "distributed": True}),
]


@pytest.fixture(scope="module")
def degraded():
    return [(getattr(ja, fn)(*args, **kw), getattr(ta, fn)(*args, **kw))
            for fn, args, kw in DEGRADED]


def test_degraded_reads_equal(degraded):
    assert [port for _ref, port in degraded] == [ref for ref, _port in degraded]


def test_degraded_reads_low_p_all_equal_one(degraded):
    for _ref, port in degraded[:3]:
        assert port == pytest.approx(1.0, abs=0.1)


def test_degraded_reads_distributed_ec_worst(degraded):
    ec, lr, co = (port for _ref, port in degraded[3:])
    assert co < ec and lr < ec


@pytest.mark.parametrize("name,stretch", [("core_params_for_stretch", 1.5),
                                          ("ec_params_for_stretch", 1.5),
                                          ("lrc_params_for_stretch", 1.67)])
def test_param_sweeps_equal_and_nonempty(name, stretch):
    port = getattr(ta, name)(stretch)
    assert port and port == getattr(ja, name)(stretch)


def test_codes_agree_on_stretch():
    for n, k, t in ta.core_params_for_stretch(1.5):
        assert TCode(n, k, t).stretch == JCode(n, k, t).stretch
