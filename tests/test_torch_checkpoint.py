"""The port's CORE checkpoint layer (``repro_torch.checkpoint``) against
the JAX package's: the cases of tests/test_checkpoint.py run on both
packages and their results compared, byte for byte.

Both sides get the same state: the reference's ``make_state`` tree, and
for the port the same leaves with the bfloat16 embedding as a torch
tensor holding the reference's bf16 bits. Byte streams, ``LeafSpec``s,
group matrices, placement and store checksums must be identical, and
restores after the same node failures bit-equal (leaves compared as
byte views, so bf16 needs no float comparison). The port runs its codec
with ``device="cpu"``.
"""

from __future__ import annotations

from collections import OrderedDict

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.checkpoint as jck  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.storage as jst  # noqa: E402
import repro_torch.checkpoint as tck  # noqa: E402
from repro_torch.checkpoint import partition as tpart  # noqa: E402
from repro_torch.core.product_code import CoreCode as TCode  # noqa: E402
from repro_torch.storage.blockstore import BlockStore as TStore  # noqa: E402
from repro_torch.storage.netmodel import ClusterProfile as TProfile  # noqa: E402
from repro_torch.storage.repair import UnrecoverableError as TUnrecoverable  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves, and the
    suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_pair(x):
    """(jnp bf16 array, torch bf16 tensor with the same bits)."""
    ref = jnp.asarray(x, dtype=jnp.bfloat16)
    bits = np.asarray(ref).view(np.uint16).astype(np.int16)
    return ref, torch.from_numpy(bits).view(torch.bfloat16)


def make_states(seed=0):
    """tests/test_checkpoint.py's ``make_state`` for both packages."""
    rng = np.random.default_rng(seed)
    w1 = rng.normal(size=(64, 128)).astype(np.float32)
    b1 = rng.normal(size=(128,)).astype(np.float32)
    ej, et = _bf16_pair(rng.normal(size=(1000, 64)))
    mu = rng.normal(size=(64, 128)).astype(np.float32)
    nu = rng.normal(size=(64, 128)).astype(np.float32)
    step = np.asarray(123, dtype=np.int64)

    def tree(embed):
        return {"params": {"w1": w1, "b1": b1, "embed": embed}, "opt": {"mu": mu, "nu": nu},
                "step": step}

    return tree(ej), tree(et)


def _bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        return leaf.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(leaf).tobytes()


def assert_restored(ref_tree, port_tree):
    """Same structure, dtypes, shapes and bytes, leaf for leaf."""
    ref_leaves, ref_def = jax.tree.flatten(ref_tree)
    port_leaves, _ = tpart.flatten(port_tree)
    assert jax.tree.structure(port_tree) == ref_def
    assert len(port_leaves) == len(ref_leaves)
    for r, p in zip(ref_leaves, port_leaves):
        assert isinstance(p, torch.Tensor) and p.device.type == "cpu"
        assert str(p.dtype).removeprefix("torch.") == str(np.asarray(r).dtype)
        assert tuple(p.shape) == np.asarray(r).shape
        assert _bytes(p) == _bytes(r)


def make_ckpts(num_nodes=200, block_size=1 << 12, nkt=(9, 6, 3)):
    js, ts = jst.BlockStore(num_nodes=num_nodes), TStore(num_nodes=num_nodes)
    jc = jck.CoreCheckpointer(js, jcore.CoreCode(*nkt), jst.ClusterProfile.network_critical(),
                              block_size=block_size)
    tc = tck.CoreCheckpointer(ts, TCode(*nkt), TProfile.network_critical(),
                              block_size=block_size, device="cpu")
    return (js, jc), (ts, tc)


def test_exports():
    assert set(tck.__all__) == set(jck.__all__) == {
        "CheckpointManifest", "CoreCheckpointer", "partition"}
    assert tck.partition is tpart


# ---------------------------------------------------------------------------
# partition: the same stream, specs and objects as the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_specs_and_objects_identical(seed):
    jtree, ttree = make_states(seed)
    jp = jck.partition
    sj, _tdj, spj = jp.tree_to_stream(jtree)
    st, _tdt, spt = tpart.tree_to_stream(ttree)
    assert st == sj
    assert [vars(s) for s in spt] == [vars(s) for s in spj]
    oj, padj, gj = jp.stream_to_objects(sj, 1 << 12, 6, 3)
    ot, padt, gt = tpart.stream_to_objects(st, 1 << 12, 6, 3)
    assert (padt, gt) == (padj, gj) and np.array_equal(ot, oj)
    assert tpart.objects_to_stream(ot, len(st)) == jp.objects_to_stream(oj, len(sj))


def test_leaf_order_is_jax_order_whatever_the_insertion_order():
    rng = np.random.default_rng(4)
    leaves = {k: rng.normal(size=(3, k)).astype(np.float32) for k in (5, 1, 3)}
    built_reversed = {"z": {"b": leaves[5], "a": leaves[1]}, "m": [leaves[3], None, ()],
                      "a": (np.asarray(7, dtype=np.int32),)}
    ref_stream, _, ref_specs = jck.partition.tree_to_stream(built_reversed)
    stream, treedef, specs = tpart.tree_to_stream(built_reversed)
    assert stream == ref_stream
    assert [vars(s) for s in specs] == [vars(s) for s in ref_specs]
    back = tpart.stream_to_tree(stream, treedef, specs)
    assert list(back) == ["a", "m", "z"] and list(back["z"]) == ["a", "b"]
    assert back["m"][1] is None and back["m"][2] == ()
    assert back["a"][0].shape == () and int(back["a"][0]) == 7


def test_ordered_dict_keeps_its_order_as_in_jax():
    od = OrderedDict([("w", np.ones(3, np.float32)), ("b", np.zeros(2, np.int8))])
    ref_stream, _, _ = jck.partition.tree_to_stream(od)
    stream, treedef, specs = tpart.tree_to_stream(od)
    assert stream == ref_stream
    back = tpart.stream_to_tree(stream, treedef, specs)
    assert isinstance(back, OrderedDict) and list(back) == ["w", "b"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16,
                                   torch.int64, torch.int8, torch.uint8, torch.bool])
def test_torch_leaves_round_trip_bit_for_bit(dtype):
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn(7, 5, generator=gen) * 50).to(dtype)
    tree = {"x": x, "odd": torch.arange(3, dtype=torch.uint8), "empty": x[:0],
            "zero_d": x[0, 0].clone(), "view": x.t()}
    stream, treedef, specs = tpart.tree_to_stream(tree)
    back = tpart.stream_to_tree(stream, treedef, specs)
    for key, leaf in tree.items():
        assert back[key].dtype == leaf.dtype and back[key].shape == leaf.shape, key
        assert _bytes(back[key]) == _bytes(leaf), key


def test_numpy_and_torch_leaves_serialize_alike():
    arr = np.random.default_rng(6).normal(size=(4, 9)).astype(np.float32)
    assert tpart.tree_to_stream([arr])[0] == tpart.tree_to_stream([torch.from_numpy(arr)])[0]
    assert tpart.tree_to_stream([arr])[2][0] == tpart.tree_to_stream(
        [torch.from_numpy(arr)])[2][0]


# ---------------------------------------------------------------------------
# save: identical group matrices, placement and checksums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_save_stores_the_reference_bytes(seed):
    jtree, ttree = make_states(seed)
    (js, jc), (ts, tc) = make_ckpts()
    mj, mt = jc.save(100, jtree), tc.save(100, ttree)
    assert mt.group_ids == mj.group_ids and mt.total_bytes == mj.total_bytes
    assert [vars(s) for s in mt.leaf_specs] == [vars(s) for s in mj.leaf_specs]
    assert ts.placement == js.placement and ts.checksums == js.checksums
    for key, blk in js.blocks.items():
        assert np.array_equal(ts.blocks[key], blk), key
    assert mt.save_seconds >= 0.0


def _fail_same(js, ts, keys):
    victims = [js.node_of(k) for k in keys]
    assert victims == [ts.node_of(k) for k in keys]
    js.fail_nodes(victims)
    ts.fail_nodes(victims)


def _report(rep):
    return (rep.mode, rep.blocks_fetched, rep.bytes_fetched, rep.blocks_repaired,
            rep.recovered)


# (seed, cells failed in group 0) of each reference restore case
RESTORES = {
    "roundtrip": (0, []),
    "single_node": (1, [(0, 2)]),
    "multi_same_group": (2, [(0, 1), (0, 4), (2, 7)]),
    "beyond_rs_via_vertical": (4, [(0, 0), (0, 1), (0, 2), (0, 3)]),
}


@pytest.mark.parametrize("case", sorted(RESTORES))
def test_degraded_restore_bit_equal(case):
    seed, cells = RESTORES[case]
    jtree, ttree = make_states(seed)
    (js, jc), (ts, tc) = make_ckpts()
    gid = jc.save(7, jtree).group_ids[0]
    tc.save(7, ttree)
    _fail_same(js, ts, [(gid, r, c) for r, c in cells])
    jr, jrep = jc.restore(7)
    tr, trep = tc.restore(7)
    assert_restored(jtree, tr)
    assert_restored(jr, tr)
    assert _report(trep) == _report(jrep)
    assert (trep.blocks_fetched > 0) and trep.compute_time >= 0.0


def test_background_repair_replenishes_blocks():
    jtree, ttree = make_states(3)
    (js, jc), (ts, tc) = make_ckpts()
    gid = jc.save(9, jtree).group_ids[0]
    tc.save(9, ttree)
    _fail_same(js, ts, [(gid, 1, 0), (gid, 3, 5)])
    jrep, trep = jc.repair(9), tc.repair(9)
    assert _report(trep) == _report(jrep)
    assert trep.recovered and trep.blocks_repaired >= 2
    assert not ts.failure_matrix(gid, tc.code.rows, tc.code.n).any()
    assert ts.placement == js.placement
    assert all(ts.verify(k) for k in ts.blocks)
    for key, blk in js.blocks.items():
        assert np.array_equal(ts.blocks[key], blk), key
    restored, rd = tc.restore(9)
    assert_restored(jtree, restored)
    assert rd.blocks_fetched == len(tc.manifests[9].group_ids) * tc.code.t * tc.code.k


def test_checkpoint_restart_training_semantics():
    (_js, jc), (_ts, tc) = make_ckpts()
    for step, seed in ((100, 5), (200, 6)):
        jtree, ttree = make_states(seed)
        jc.save(step, jtree)
        tc.save(step, ttree)
    assert tc.latest_step() == jc.latest_step() == 200
    assert_restored(jc.restore(200)[0], tc.restore(200)[0])
    assert_restored(make_states(6)[0], tc.restore(200)[0])


def test_restore_fails_loud_when_unrecoverable():
    jtree, ttree = make_states(7)
    (js, jc), (ts, tc) = make_ckpts()
    gid = jc.save(11, jtree).group_ids[0]
    tc.save(11, ttree)
    m = tc.code.m
    keys = [(gid, r, c) for r in (0, 1) for c in range(m + 1)]
    victims = sorted({js.node_of(k) for k in keys})
    js.fail_nodes(victims)
    ts.fail_nodes(victims)
    with pytest.raises(jst.UnrecoverableError):
        jc.restore(11)
    with pytest.raises(TUnrecoverable):
        tc.restore(11)


def test_save_at_the_card_phase_shape_matches_on_a_small_tree():
    """The code and block size of the card phase, (14, 12, 5) with 64 KiB
    blocks, on the small tree: the same groups and bytes as the reference."""
    jtree, ttree = make_states(0)
    (js, jc), (ts, tc) = make_ckpts(num_nodes=100, block_size=1 << 16, nkt=(14, 12, 5))
    mj, mt = jc.save(1, jtree), tc.save(1, ttree)
    assert mt.group_ids == mj.group_ids and ts.checksums == js.checksums
    gid = mj.group_ids[0]
    _fail_same(js, ts, [(gid, 0, 0), (gid, 1, 3)])
    assert_restored(jtree, tc.restore(1)[0])
