"""Full-stack property cases of tests/test_e2e_property.py on both
packages: random (n, k, t) codes x random failure patterns x every
repair mode and scheduler, and random mixed-dtype checkpoint trees
through CORE save -> node kills -> degraded restore. The same draws go
to the JAX package and to the port (``device="cpu"``); repair reports,
stored bytes and restored leaves must be identical, and each side must
restore every block the recoverability checker promises."""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.checkpoint.core_ckpt as jckpt  # noqa: E402
import repro.core.product_code as jpc  # noqa: E402
import repro.core.recoverability as jrec  # noqa: E402
import repro.storage.blockstore as jbs  # noqa: E402
import repro.storage.netmodel as jnet  # noqa: E402
import repro.storage.repair as jrep  # noqa: E402
import repro_torch.checkpoint.core_ckpt as tckpt  # noqa: E402
import repro_torch.core.product_code as tpc  # noqa: E402
import repro_torch.core.recoverability as trec  # noqa: E402
import repro_torch.storage.blockstore as tbs  # noqa: E402
import repro_torch.storage.netmodel as tnet  # noqa: E402
import repro_torch.storage.repair as trep  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves, and the
    suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CODES = [(9, 6, 3), (14, 12, 5), (6, 4, 2), (8, 6, 4)]
SIDES = {
    "jax": (jpc, jrec, jbs, jnet, jrep, jckpt, {}),
    "torch": (tpc, trec, tbs, tnet, trep, tckpt, {"device": "cpu"}),
}


def _repair_case(side, nkt, p, seed, mode, scheduler):
    pc, rec, bs, net, rep, _ck, dev = SIDES[side]
    n, k, t = nkt
    code = pc.CoreCode(n, k, t)
    rng = np.random.default_rng(seed)
    objects = rng.integers(0, 256, (t, k, 512), dtype=np.uint8)
    matrix = np.asarray(pc.CoreCodec(code, **dev).encode(objects))
    fm = rng.random((t + 1, n)) < p
    store = bs.BlockStore(num_nodes=max(40, (t + 1) * n))
    store.put_group("g", matrix)
    for r, c in zip(*np.nonzero(fm)):
        store.drop_block(("g", int(r), int(c)))
    fixer = rep.BlockFixer(store, code, net.ClusterProfile.computation_critical(),
                           mode=mode, scheduler=scheduler, **dev)
    report = fixer.fix_group("g")
    if mode == "core":
        expected_full = bool(rec.is_recoverable(code, fm))
    else:
        expected_full = bool((fm.sum(axis=1) <= n - k).all())
    got = {key: blk.tobytes() for key, blk in store.blocks.items() if store.available(key)}
    return ((report.mode, report.blocks_fetched, report.bytes_fetched, report.blocks_repaired,
             report.network_time, report.schedule, report.recovered),
            expected_full, got, matrix, dict(store.placement))


@settings(max_examples=25, deadline=None)
@given(
    code_i=st.integers(0, len(CODES) - 1),
    p=st.sampled_from([0.05, 0.12, 0.25]),
    seed=st.integers(0, 1000),
    mode=st.sampled_from(["core", "hdfs_raid", "hdfs_raid_opt"]),
    scheduler=st.sampled_from(["rgs", "column_first", "row_first"]),
)
def test_random_pattern_repair_roundtrip(code_i, p, seed, mode, scheduler):
    args = (CODES[code_i], p, seed, mode, scheduler)
    ref = _repair_case("jax", *args)
    port = _repair_case("torch", *args)
    report, expected_full, got, matrix, placement = port
    assert report == ref[0] and got == ref[2] and placement == ref[4]
    assert np.array_equal(matrix, ref[3])
    assert report[-1] == expected_full == ref[1]
    n, t = CODES[code_i][0], CODES[code_i][2]
    for r in range(t + 1):
        for c in range(n):
            if expected_full or ("g", r, c) in got:
                assert got[("g", r, c)] == matrix[r, c].tobytes(), (r, c)


DTYPES = [np.float32, np.int32, np.uint8, np.float16]


def _checkpoint_case(side, seed, n_leaves, kill):
    pc, _rec, bs, _net, _rep, ck, dev = SIDES[side]
    rng = np.random.default_rng(seed)
    tree = {
        f"leaf{i}": rng.standard_normal(
            tuple(rng.integers(1, 40, size=rng.integers(1, 3)))
        ).astype(DTYPES[rng.integers(0, len(DTYPES))])
        for i in range(n_leaves)
    }
    store = bs.BlockStore(num_nodes=20)
    ckpt = ck.CoreCheckpointer(store, pc.CoreCode(9, 6, 3), block_size=1 << 10, **dev)
    ckpt.save(1, tree)
    checksums = dict(store.checksums)
    store.fail_nodes(list(range(kill)))
    restored, report = ckpt.restore(1)
    return tree, restored, checksums, (report.blocks_fetched, report.bytes_fetched)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 100), n_leaves=st.integers(1, 4), kill=st.integers(0, 2))
def test_checkpoint_roundtrip_random_trees(seed, n_leaves, kill):
    tree, ref, ref_sums, ref_rep = _checkpoint_case("jax", seed, n_leaves, kill)
    _tree, port, sums, rep = _checkpoint_case("torch", seed, n_leaves, kill)
    assert sums == ref_sums and rep == ref_rep
    assert sorted(port) == sorted(tree)
    for name, leaf in tree.items():
        got = port[name]
        assert isinstance(got, torch.Tensor)
        assert str(got.dtype).removeprefix("torch.") == str(leaf.dtype)
        assert np.array_equal(got.numpy(), leaf) and np.array_equal(got.numpy(), ref[name])
