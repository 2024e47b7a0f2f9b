"""The port's storage substrate (``BlockStore``, ``BlockFixer`` in its
three modes, degraded reads, rack-aware placement) against the JAX
package's: the cases of tests/test_storage.py run on both packages and
their results compared byte for byte. The port's codec and fixer run
with ``device="cpu"``. Repair reports are compared field for field
except ``compute_time``, which is a measured wall time."""

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


def _side(pkg: str, dev: dict, gw_kw: dict) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(pc=mod("core.product_code"), bs=mod("storage.blockstore"),
                           net=mod("storage.netmodel"), rep=mod("storage.repair"),
                           planner=mod("gateway.planner"),
                           gw=mod("gateway"), dev=dev, gw_kw=gw_kw)


SIDES = {
    "jax": _side("repro", {}, {"interpret": True, "autotune": False}),
    "torch": _side("repro_torch", {"device": "cpu"}, {"device": "cpu", "autotune": False}),
}


def both(fn, *args, **kw):
    """``fn(side, ...)`` on both packages -> (jax result, torch result)."""
    return fn(SIDES["jax"], *args, **kw), fn(SIDES["torch"], *args, **kw)


def make_group(s, code, store, group_id="g0", q=1024, seed=0):
    rng = np.random.default_rng(seed)
    objects = rng.integers(0, 256, size=(code.t, code.k, q), dtype=np.uint8)
    matrix = np.asarray(s.pc.CoreCodec(code, **s.dev).encode(objects))
    store.put_group(group_id, matrix)
    return objects, matrix


def _fixer(s, store, code, mode="core", profile="network_critical", **kw):
    prof = getattr(s.net.ClusterProfile, profile)()
    return s.rep.BlockFixer(store, code, prof, mode=mode, **kw, **s.dev)


def _report(rep):
    return (rep.mode, rep.blocks_fetched, rep.bytes_fetched, rep.blocks_repaired,
            rep.network_time, rep.schedule, rep.recovered)


def _blocks(store):
    return {k: v.tobytes() for k, v in store.blocks.items()}


def _state(store):
    return dict(store.placement), _blocks(store), dict(store.checksums)


def _basic(s):
    code = s.pc.CoreCode(9, 6, 3)
    store = s.bs.BlockStore(num_nodes=40)
    _objects, matrix = make_group(s, code, store)
    nodes = [store.node_of(("g0", r, c)) for r in range(4) for c in range(9)]
    store.fail_nodes([store.node_of(("g0", 1, 2))])
    return matrix.tobytes(), nodes, store.available(("g0", 1, 2)), \
        store.failure_matrix("g0", 4, 9).tolist()


def test_placement_and_failure_matrix_equal():
    ref, port = both(_basic)
    assert port == ref
    _m, nodes, avail, fm = port
    assert len(set(nodes)) == len(nodes) and not avail
    assert np.asarray(fm).sum() == 1 and fm[1][2]


def _fix(s, nkt, cells, mode, num_nodes=60, q=1024, **kw):
    code = s.pc.CoreCode(*nkt)
    store = s.bs.BlockStore(num_nodes=num_nodes)
    _, matrix = make_group(s, code, store, q=q)
    store.fail_nodes([store.node_of(("g0", r, c)) for r, c in cells])
    rep = _fixer(s, store, code, mode, **kw).fix_group("g0")
    restored = all(np.array_equal(store.blocks[("g0", r, c)], matrix[r, c])
                   for r, c in cells if ("g0", r, c) in store.blocks)
    return _report(rep), _state(store), restored


FIXES = [
    # (name, code, failed cells, mode, expected fetch) — the reference's cases
    ("x-hdfs_raid", (9, 6, 3), [(1, 3)], "hdfs_raid", 8),
    ("x-hdfs_raid_opt", (9, 6, 3), [(1, 3)], "hdfs_raid_opt", 6),
    ("x-core", (9, 6, 3), [(1, 3)], "core", 3),
    ("xx-hdfs_raid", (9, 6, 3), [(1, 3), (1, 5)], "hdfs_raid", 15),
    ("xx-hdfs_raid_opt", (9, 6, 3), [(1, 3), (1, 5)], "hdfs_raid_opt", 6),
    ("xx-core", (9, 6, 3), [(1, 3), (1, 5)], "core", 6),
    ("14-12-5-core", (14, 12, 5), [(2, 1), (2, 7)], "core", 10),
    ("14-12-5-opt", (14, 12, 5), [(2, 1), (2, 7)], "hdfs_raid_opt", 12),
]


@pytest.mark.parametrize("nkt,cells,mode,fetched", [f[1:] for f in FIXES],
                         ids=[f[0] for f in FIXES])
def test_fix_group_equal_and_fetch_counts(nkt, cells, mode, fetched):
    num_nodes = 120 if nkt[0] == 14 else 60
    ref, port = both(_fix, nkt, cells, mode, num_nodes=num_nodes)
    assert port == ref
    report, _state_, restored = port
    assert report[-1] and restored and report[1] == fetched


# (mode, row family, cells lost, row read degraded or None for a repair)
# of CORE (9, 6, 3): every caller of the fixer's codec, one case each
ONE_PATH = {
    "core": ("core", None, [(0, 2), (1, 2)], None),
    "hdfs_raid": ("hdfs_raid", None, [(1, 3), (1, 5)], None),
    "hdfs_raid_opt": ("hdfs_raid_opt", None, [(1, 3), (1, 5)], None),
    "lrc-local": ("core", "lrc", [(0, 0)], None),
    "lrc-global": ("core", "lrc", [(0, 8)], None),
    "read-row-decode": ("core", None, [(0, 2), (2, 2)], 0),
    "read-vertical": ("core", None, [(0, 2)], 0),
}


def _one_path(s, mode, fam, cells, read_row):
    """Two groups, the same cells lost in each, repaired (or read degraded)
    one after the other by one fixer: the bytes that came out of the
    first, read after the second overwrote the fixer's buffers; on the
    port also whether every codec call read the reused source buffer and
    whether any array that came out of the first shares its memory."""
    code = s.pc.CoreCode(9, 6, 3)
    store = s.bs.BlockStore(num_nodes=60)
    family = None if fam is None else s.planner.make_family(code, fam, **s.dev)
    for g in range(2):
        if family is None:
            make_group(s, code, store, group_id=f"g{g}", seed=40 + g)
            continue
        objects = np.random.default_rng(40 + g).integers(0, 256, (1, code.k, 1024),
                                                         dtype=np.uint8)
        store.put_group(f"g{g}", np.asarray(family.encode_group(objects)))
    fixer = _fixer(s, store, code, mode, family=family)
    staged = []
    if s.dev:
        measure = fixer._measure

        def spy(fn, *args):
            src = args[-1]
            staged.append(isinstance(src, torch.Tensor) and src.untyped_storage().data_ptr()
                          == fixer._sources.buf.untyped_storage().data_ptr())
            return measure(fn, *args)

        fixer._measure = spy
    out, reports = [], []
    for g in ("g0", "g1"):
        for r, c in cells:
            store.drop_block((g, r, c))
        if read_row is None:
            reports.append(_report(fixer.fix_group(g)))
            out.append([store.get((g, r, c)) for r, c in cells])
        else:
            data, rep = fixer.degraded_read(g, read_row)
            reports.append(_report(rep))
            out.append([data])
    first = [a.tobytes() for a in out[0]]
    shared = None
    if s.dev:
        bufs = [fixer._sources.buf.numpy(), fixer._rebuilt.buf.numpy()]
        shared = any(np.shares_memory(a, b) for a in out[0] for b in bufs)
    return (first, reports), (staged, shared)


@pytest.mark.parametrize("case", list(ONE_PATH))
def test_every_codec_call_stages_in_the_reused_buffer(case):
    (ref, _), (port, (staged, shared)) = both(_one_path, *ONE_PATH[case])
    assert port == ref
    assert all(rep[-1] for rep in port[1])
    assert staged and all(staged) and shared is False


def _beyond_rs(s):
    code = s.pc.CoreCode(9, 6, 3)
    store = s.bs.BlockStore(num_nodes=60)
    _, matrix = make_group(s, code, store)
    cells = [(1, c) for c in range(4)]
    store.fail_nodes([store.node_of(("g0", r, c)) for r, c in cells])
    raid = _report(_fixer(s, store, code, "hdfs_raid_opt").fix_group("g0"))
    core = _report(_fixer(s, store, code, "core").fix_group("g0"))
    ok = all(np.array_equal(store.blocks[("g0", r, c)], matrix[r, c]) for r, c in cells)
    return raid, core, ok, _state(store)


def test_core_repairs_beyond_rs_tolerance():
    ref, port = both(_beyond_rs)
    assert port == ref
    raid, core, ok, _ = port
    assert not raid[-1] and core[-1] and ok


def _profiles(s):
    code = s.pc.CoreCode(14, 12, 5)
    out = {}
    for mode in ("core", "hdfs_raid_opt"):
        store = s.bs.BlockStore(num_nodes=120)
        make_group(s, code, store, q=1 << 18)
        store.fail_nodes([store.node_of(("g0", 2, 3))])
        fixer = _fixer(s, store, code, mode)
        first = fixer.fix_group("g0")
        store.fail_nodes([store.node_of(("g0", 2, 4))])
        out[mode] = (_report(first), _report(fixer.fix_group("g0")))
    return out


def test_network_vs_compute_profiles():
    ref, port = both(_profiles)
    assert port == ref
    core, raid = port["core"][1], port["hdfs_raid_opt"][1]
    assert core[4] < raid[4] and core[2] < raid[2]


def _degraded(s, cells):
    code = s.pc.CoreCode(9, 6, 3)
    store = s.bs.BlockStore(num_nodes=60)
    objects, _ = make_group(s, code, store)
    store.fail_nodes([store.node_of(("g0", r, c)) for r, c in cells])
    data, report = _fixer(s, store, code).degraded_read("g0", 0)
    return (np.asarray(data).tobytes(), objects[0].tobytes(), _report(report),
            store.available(("g0", 0, 2)))


@pytest.mark.parametrize("cells,fetched", [([(0, 2)], 8), ([(0, 2), (2, 2)], 6)],
                         ids=["vertical", "row-decode"])
def test_degraded_read_equal(cells, fetched):
    ref, port = both(_degraded, cells)
    assert port == ref
    data, want, report, avail = port
    assert data == want and report[1] == fetched and not avail


def _partial(s):
    code = s.pc.CoreCode(9, 6, 3)
    store = s.bs.BlockStore(num_nodes=80)
    _, matrix = make_group(s, code, store)
    bad = [(0, c) for c in range(4)] + [(1, c) for c in range(4)]
    store.fail_nodes([store.node_of(("g0", r, c)) for r, c in bad + [(3, 8)]])
    report = _report(_fixer(s, store, code).fix_group("g0"))
    return report, np.array_equal(store.blocks[("g0", 3, 8)], matrix[3, 8]), _state(store)


def test_partial_recovery_across_clusters():
    ref, port = both(_partial)
    assert port == ref
    assert not port[0][-1] and port[1]


# -- rack-aware placement ------------------------------------------------------

def _racks(s):
    code = s.pc.CoreCode(9, 6, 3)
    store = s.bs.BlockStore(num_nodes=36, nodes_per_rack=3)
    for g in range(6):
        make_group(s, code, store, group_id=f"g{g}", seed=g)
    racks = {g: [[store.rack_of(store.node_of((f"g{g}", r, c))) for c in range(code.n)]
                 for r in range(code.rows)] for g in range(6)}
    return racks, dict(store.placement)


def test_rack_aware_placement_row_and_col_distinct():
    ref, port = both(_racks)
    assert port == ref
    for grid in port[0].values():
        assert all(len(set(row)) == 9 for row in grid)
        assert all(len({grid[r][c] for r in range(4)}) == 4 for c in range(9))


def _rack_failures(s):
    code = s.pc.CoreCode(9, 6, 3)
    store = s.bs.BlockStore(num_nodes=36, nodes_per_rack=3)
    for g in range(4):
        make_group(s, code, store, group_id=f"g{g}", seed=10 + g)
    worst = []
    for rack in range(12):
        lo = rack * 3
        store.fail_nodes([lo, lo + 1, lo + 2])
        for g in range(4):
            fm = store.failure_matrix(f"g{g}", code.rows, code.n)
            worst.append((int(fm.sum(axis=1).max()), int(fm.sum(axis=0).max())))
        for node in (lo, lo + 1, lo + 2):
            store.heal_node(node)
    return worst


def test_whole_rack_failure_costs_one_block_per_line():
    ref, port = both(_rack_failures)
    assert port == ref
    assert all(r <= 1 and c <= 1 for r, c in port)


def _rack_writeback(s):
    code = s.pc.CoreCode(9, 6, 3)
    store = s.bs.BlockStore(num_nodes=36, nodes_per_rack=3)
    _, matrix = make_group(s, code, store, seed=3)
    key = ("g0", 1, 4)
    store.fail_nodes([store.node_of(key)])
    report = _report(_fixer(s, store, code).fix_group("g0"))
    new_rack = store.rack_of(store.node_of(key))
    peers = {store.rack_of(store.node_of(("g0", r, c)))
             for r in range(code.rows) for c in range(code.n)
             if (r, c) != (1, 4) and (r == 1 or c == 4) and store.available(("g0", r, c))}
    return report, np.array_equal(store.blocks[key], matrix[1, 4]), new_rack, peers, \
        _state(store)


def test_rack_aware_repair_writeback_keeps_invariant():
    ref, port = both(_rack_writeback)
    assert port == ref
    report, ok, new_rack, peers, _ = port
    assert report[-1] and ok and new_rack not in peers


def test_rack_aware_placement_needs_enough_racks():
    for s in SIDES.values():
        store = s.bs.BlockStore(num_nodes=12, nodes_per_rack=3)
        with pytest.raises(s.bs.PlacementError):
            make_group(s, s.pc.CoreCode(9, 6, 3), store)


def _rackless(s):
    code = s.pc.CoreCode(9, 6, 3)
    a, b = s.bs.BlockStore(num_nodes=40), s.bs.BlockStore(num_nodes=40, nodes_per_rack=None)
    make_group(s, code, a, seed=5)
    make_group(s, code, b, seed=5)
    return a.placement == b.placement, dict(a.placement)


def test_rackless_store_placement_unchanged():
    ref, port = both(_rackless)
    assert port == ref and port[0]


def _gateway_racks(s):
    code = s.pc.CoreCode(9, 6, 3)
    cfg = s.gw.GatewayConfig(batch_window=0.01, nodes_per_rack=3, decode_cost=0.002,
                             **s.gw_kw)
    gw = s.gw.ObjectGateway(code, s.net.ClusterProfile.network_critical(), 36, cfg)
    rng = np.random.default_rng(9)
    gw.load_objects(rng.integers(0, 256, (6, code.k, 1024), dtype=np.uint8))
    wl = s.gw.WorkloadConfig(num_objects=6, num_requests=40, arrival_rate=500.0, seed=9)
    rep = gw.serve(s.gw.generate_requests(wl), [])
    return (gw.store.nodes_per_rack, len(rep.completed), dict(gw.store.placement),
            [(r.time, r.object_id, r.latency, r.payload_digest) for r in rep.records])


def test_gateway_wires_rack_aware_placement():
    ref, port = both(_gateway_racks)
    assert port == ref
    assert port[:2] == (3, 40)
