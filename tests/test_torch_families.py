"""Code families (RS / CORE / LRC behind one planner) and the failure
inter-arrival laws, on both packages: the twin of tests/test_families.py.

Each case of the reference runs on the JAX package (Pallas in
interpret mode) and on the port (``device="cpu"``, its kernels' plain
torch versions), asserts the reference's claims on both, and holds the
two packages' results equal: geometry, tolerances, repair costs and
plans, the BlockFixer's fetch counts, the degraded GETs' payload
digests, and the inter-arrival draws and scenario traces exactly.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves, and the
    suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _side(pkg: str, kw: dict) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    pc = mod("core.product_code")
    return SimpleNamespace(
        pc=pc, gw=mod("gateway"), planner=mod("gateway.planner"), trace=mod("scenario.trace"),
        net=mod("storage.netmodel"), code=pc.CoreCode(9, 6, 3), kw=kw,
    )


SIDES = {
    "jax": _side("repro", {"interpret": True, "autotune": False}),
    "torch": _side("repro_torch", {"device": "cpu", "autotune": False}),
}
NUM_OBJECTS, Q = 6, 256


def both(fn, *args, **kw):
    """``fn(side, ...)`` on both packages; asserts the results equal and
    returns the port's."""
    ref, port = fn(SIDES["jax"], *args, **kw), fn(SIDES["torch"], *args, **kw)
    assert port == ref
    return port


def _gateway(s, fam: str, seed: int = 3, **cfg_kw):
    cfg = s.gw.GatewayConfig(code_family=fam, record_payloads=True, **cfg_kw, **s.kw)
    gw = s.gw.ObjectGateway(s.code, s.net.ClusterProfile.network_critical(), 40, cfg)
    rng = np.random.default_rng(seed)
    gw.load_objects(rng.integers(0, 256, (NUM_OBJECTS, s.code.k, Q), dtype=np.uint8))
    return gw


# -- family geometry + cost model ------------------------------------------


def _geometry(s):
    fams = {name: s.planner.make_family(s.code, name) for name in ("core", "rs", "lrc")}
    with pytest.raises(ValueError):
        s.planner.make_family(s.code, "raptor")
    return (set(s.planner.FAMILY_NAMES), {
        name: (f.rows, f.n, f.k, f.objects_per_group, f.tolerance, f.storage_overhead)
        for name, f in fams.items()})


def test_family_geometry_and_tolerance():
    names, geo = both(_geometry)
    code = SIDES["torch"].code
    m = code.n - code.k
    assert names == {"core", "rs", "lrc"}
    assert geo["core"][:4] == (code.t + 1, code.n, code.k, code.t)
    for fam in ("rs", "lrc"):
        assert geo[fam][:4] == (1, code.n, code.k, 1)
    assert geo["core"][4] == geo["rs"][4] == m and geo["lrc"][4] == m - 1
    assert geo["rs"][5] == geo["lrc"][5] == code.n / code.k
    assert geo["core"][5] == pytest.approx(code.stretch) and geo["core"][5] > geo["rs"][5]


def _costs(s):
    out = {}
    for name in ("core", "rs", "lrc"):
        f = s.planner.make_family(s.code, name)
        out[name] = ([f.single_repair_cost(c) for c in range(s.code.n)], f.avg_repair_cost)
    lrc = s.planner.make_family(s.code, "lrc")
    groups = [lrc.code.local_group(c) is not None for c in range(s.code.n)]
    return out, groups


def test_single_repair_cost_model():
    costs, local = both(_costs)
    code = SIDES["torch"].code
    assert costs["core"][0] == [code.t] * code.n
    assert costs["rs"][0] == [code.k] * code.n
    assert costs["lrc"][0] == [code.k // 2 if g else code.k for g in local]
    assert costs["lrc"][1] < costs["rs"][1] and costs["core"][1] < costs["rs"][1]


def _plans(s):
    out = {}
    for name in ("lrc", "rs"):
        plan = s.planner.make_family(s.code, name).repair_plan([0])
        out[name] = [(kind, list(map(int, src)), tuple(map(int, rep))) for kind, src, rep in plan]
    return out


def test_lrc_repair_plan_is_local_first():
    plans = both(_plans)
    code = SIDES["torch"].code
    (kind, sources, repaired), = plans["lrc"]
    assert kind == "local" and len(sources) == code.k // 2 and repaired == (0,)
    assert len(plans["rs"][0][1]) == code.k


# -- repair through the real BlockFixer ------------------------------------


def _repair_one_block(s, fam: str, col: int):
    gw = _gateway(s, fam, seed=7)
    gid, row = gw._objects[0]
    key = (gid, row, col)
    gw.store.drop_block(key)
    rep = gw.fixer.fix_group(gid)
    assert rep.recovered and gw.store.available(key)
    return rep.blocks_fetched, rep.bytes_fetched


@pytest.mark.parametrize("fam", ["rs", "lrc", "core"])
def test_data_block_repair_fetches(fam):
    """A data column: LRC repairs it from its k/2 local group, CORE from
    t, RS from k."""
    code = SIDES["torch"].code
    fetched, _ = both(_repair_one_block, fam, 0)
    assert fetched == {"rs": code.k, "lrc": code.k // 2, "core": code.t}[fam]


def test_lrc_global_parity_repair_falls_back_to_k():
    code = SIDES["torch"].code
    assert SIDES["torch"].planner.make_family(code, "lrc").code.local_group(code.n - 1) is None
    fetched, _ = both(_repair_one_block, "lrc", code.n - 1)
    assert fetched == code.k


# -- byte identity through degraded paths ----------------------------------


def _serve_degraded(s, fam: str):
    gw = _gateway(s, fam, seed=11, batch_window=0.005)
    for obj, col in ((0, 0), (1, 2)):
        gw.store.drop_block((*gw._objects[obj], col))
    wl = s.gw.WorkloadConfig(num_objects=NUM_OBJECTS, num_requests=60, arrival_rate=300.0,
                             seed=11)
    rep = gw.serve(s.gw.generate_requests(wl), [])
    assert len(rep.completed) == len(rep.records) and rep.degraded_gets
    digests: dict[int, str] = {}
    for r in rep.completed:
        if r.kind == "get" and r.payload_digest:
            assert digests.setdefault(r.object_id, r.payload_digest) == r.payload_digest
    assert {0, 1} <= set(digests)
    return digests, len(rep.degraded_gets)


def test_degraded_byte_identity_across_families():
    digests = {fam: both(_serve_degraded, fam)[0] for fam in ("core", "rs", "lrc")}
    assert digests["core"] == digests["rs"] == digests["lrc"]


# -- failure inter-arrival laws (1309.0186) --------------------------------

LAWS = (("exponential", {}), ("weibull", {"interarrival_shape": 0.7}),
        ("trace", {"interarrival_samples": (0.3, 1.0, 2.5, 7.0)}))


def _gaps(s, law: str, n: int = 4000, **kw):
    cfg = s.trace.ScenarioConfig(duration=1.0, num_nodes=30, crash_rate=5.0,
                                 interarrival=law, **kw)
    rng = np.random.default_rng(0)
    return [s.trace._crash_gap(rng, cfg) for _ in range(n)]


@pytest.mark.parametrize("law,kw", LAWS, ids=[law for law, _ in LAWS])
def test_interarrival_laws_preserve_mean(law, kw):
    gaps = np.asarray(both(_gaps, law, **kw))
    assert np.all(gaps > 0)
    assert gaps.mean() == pytest.approx(1.0 / 5.0, rel=0.1)


def test_weibull_shape_below_one_is_burstier_than_exponential():
    exp = np.asarray(both(_gaps, "exponential"))
    wei = np.asarray(both(_gaps, "weibull", interarrival_shape=0.7))
    assert wei.std() > exp.std() and np.median(wei) < np.median(exp)


def test_trace_law_resamples_rescaled_empirical_gaps():
    samples = (0.5, 1.0, 4.0)
    gaps = np.asarray(both(_gaps, "trace", interarrival_samples=samples))
    scaled = set(np.round(np.asarray(samples) * (0.2 / np.mean(samples)), 12))
    assert set(np.round(gaps, 12)) <= scaled


def _invalid(s, **kw):
    with pytest.raises(ValueError) as err:
        s.trace._crash_gap(np.random.default_rng(0), s.trace.ScenarioConfig(1.0, 30, **kw))
    return str(err.value)


@pytest.mark.parametrize("kw", [dict(interarrival="pareto"),
                                dict(interarrival="weibull", interarrival_shape=0.0),
                                dict(interarrival="trace")])
def test_interarrival_validation(kw):
    both(_invalid, **kw)


def _weibull_trace(s):
    cfg = s.trace.ScenarioConfig(
        duration=2.0, num_nodes=30, nodes_per_rack=3, max_concurrent_failures=2,
        crash_rate=8.0, mean_downtime=0.1, transient_fraction=0.8,
        interarrival="weibull", interarrival_shape=0.7, seed=13)
    t1, t2 = s.trace.generate_scenario(cfg), s.trace.generate_scenario(cfg)
    assert t1.events == t2.events  # seeded: bit-for-bit reproducible
    return [(type(e).__name__, sorted(vars(e).items())) for e in t1.events]


def test_weibull_scenario_deterministic_and_bounded():
    """Equal traces on both packages; under the bursty law never more
    than ``max_concurrent_failures`` (2) nodes down at once."""
    events = both(_weibull_trace)
    assert any(name in ("FailureEvent", "CapacityLossEvent") for name, _ in events)
    down: set[int] = set()
    peak = 0
    for name, fields in events:
        node = dict(fields).get("node")
        if name in ("FailureEvent", "CapacityLossEvent"):
            down.add(node)
        elif name == "NodeRecoverEvent":
            down.discard(node)
        peak = max(peak, len(down))
    assert 0 < peak <= 2
