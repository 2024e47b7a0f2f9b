"""Node repair on the plain RS (9, 6) deployment (``code_family="rs"``),
on the CPU at 4 KiB blocks: every block a lost disk took comes back
equal to row 0 of the benchmark's plain reference
(``portbench.reference.code.CoreCode(9, 6, 1, 283)``, its own GF(2^8)
and generator); the GF(256) repair product goes to K5
(``kernels.ops.gf256_matmul``) for sources on the card and to the plain
``coding.gf256.matmul`` for sources on the CPU, with the same bytes;
CORE's horizontal step still rebuilds byte for byte; a rebuilt block is
stored as an array of its own, not a view of the reused staging
buffers; and under a profiler ``repair.plan`` records what the repair
did, untraced nothing, the repair itself the same."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.reference.code import CoreCode as ReferenceCode
from repro_torch.coding import gf256
from repro_torch.core.product_code import CoreCode
from repro_torch.gateway import GatewayConfig, ObjectGateway
from repro_torch.gateway.workload import CapacityLossEvent
from repro_torch.kernels import ops
from repro_torch.storage import repair
from repro_torch.storage.blockstore import BlockStore
from repro_torch.storage.netmodel import ClusterProfile

N, K, Q = 9, 6, 4096
STRIPES = 16


def _gateway():
    cfg = GatewayConfig(device="cpu", autotune=False, code_family="rs", verify=False,
                        verify_checksums=True, repair_on_failure=True, repair_delay=0.0)
    gw = ObjectGateway(CoreCode(N, K, 1), ClusterProfile.network_critical(), 60, cfg)
    objects = np.random.default_rng(30).integers(0, 256, (STRIPES, K, Q), dtype=np.uint8)
    gw.load_objects(objects)
    return gw, objects


def _busiest(store) -> int:
    held = {}
    for node in store.placement.values():
        held[node] = held.get(node, 0) + 1
    return min(held, key=lambda n: (-held[n], n))


def _lose(gw, node, at=1.0):
    keys = [key for key in gw.store.keys_on_node(node) if key in gw.store.blocks]
    return keys, gw.serve([], [CapacityLossEvent(at, node)])


def _expected(objects, gid: str) -> np.ndarray:
    ref = ReferenceCode(N, K, 1, 283)
    return ref.encode_group(torch.from_numpy(objects[int(gid[1:])][None]))[0].numpy()


def test_lost_node_rebuilt_equal_to_the_reference():
    gw, objects = _gateway()
    node = _busiest(gw.store)
    keys, report = _lose(gw, node)
    assert len(keys) >= 2 and all(key[1] == 0 for key in keys)
    assert sum(r.blocks_repaired for r in report.repair_reports) == len(keys)
    assert sum(r.bytes_fetched for r in report.repair_reports) == len(keys) * K * Q
    for gid, row, col in keys:
        assert gw.store.available((gid, row, col))
        got = gw.store.get((gid, row, col))
        np.testing.assert_array_equal(got, _expected(objects, gid)[col])


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself on ``cuda:0``, so the helper takes
    its card route on a host without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _operands(seed, m=2):
    rng = np.random.default_rng(seed)
    coeffs = rng.integers(0, 256, (m, K), dtype=np.uint8)
    sources = torch.from_numpy(rng.integers(0, 256, (K, Q), dtype=np.uint8))
    return coeffs, sources


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_card_tensor_goes_to_k5_and_cpu_tensor_to_the_plain_product(seed, monkeypatch):
    coeffs, sources = _operands(seed)
    want = gf256.matmul(coeffs, sources)
    k5, real_matmul = ops.gf256_matmul, gf256.matmul
    calls, plain = [], []

    def spy(c, s):
        calls.append((np.asarray(c).copy(), s.device.type))
        return k5(c, s.as_subclass(torch.Tensor))  # K5's plain version

    monkeypatch.setattr(ops, "gf256_matmul", spy)
    monkeypatch.setattr(gf256, "matmul", lambda a, b: plain.append(1) or real_matmul(a, b))

    got_card = repair._gf256_product(coeffs, sources.as_subclass(_CudaTyped))
    assert len(calls) == 1 and calls[0][1] == "cuda" and not plain
    np.testing.assert_array_equal(calls[0][0], coeffs)
    got_cpu = repair._gf256_product(coeffs, sources)
    assert len(calls) == 1 and plain == [1]
    assert torch.equal(got_card.as_subclass(torch.Tensor), want)
    assert torch.equal(got_cpu, want)


@pytest.mark.parametrize("seed", [3, 4])
def test_k5_route_and_plain_product_are_byte_identical(seed):
    """On a CPU tensor ``ops.gf256_matmul`` runs K5's own plain version
    (the bit-plane algebra the CUDA body computes): equal bytes to the
    plain product the helper takes on the CPU."""
    coeffs, sources = _operands(seed, m=3)
    assert torch.equal(ops.gf256_matmul(coeffs, sources), repair._gf256_product(coeffs, sources))


def test_core_double_failure_through_the_horizontal_step(monkeypatch):
    code = CoreCode(9, 6, 3)
    store = BlockStore(num_nodes=60)
    rng = np.random.default_rng(5)
    objects = rng.integers(0, 256, (3, 6, Q), dtype=np.uint8)
    ref = ReferenceCode(9, 6, 3, 283)
    matrix = ref.encode_group(torch.from_numpy(objects)).numpy()
    store.put_group("g0", matrix)
    cells = [(0, 2), (1, 2)]  # one column twice: no XOR rebuilds either alone
    store.fail_nodes([store.node_of(("g0", r, c)) for r, c in cells])
    products = []
    real = repair._gf256_product
    monkeypatch.setattr(repair, "_gf256_product",
                        lambda c, s: products.append(s.shape) or real(c, s))
    fixer = repair.BlockFixer(store, code, ClusterProfile.network_critical(), mode="core",
                              device="cpu")
    report = fixer.fix_group("g0")
    assert report.recovered and report.blocks_repaired == 2 and products
    for r, c in cells:
        np.testing.assert_array_equal(store.get(("g0", r, c)), matrix[r, c])


def test_rebuilt_block_is_not_a_view_of_the_staging_buffers():
    gw, objects = _gateway()
    first, _ = _lose(gw, _busiest(gw.store))
    kept = {key: gw.store.get(key) for key in first}
    before = {key: a.copy() for key, a in kept.items()}
    fixer = gw.fixer
    staged = [fixer._sources.buf.numpy(), fixer._rebuilt.buf.numpy()]
    for a in kept.values():
        assert not any(np.shares_memory(a, buf) for buf in staged)
    others = [n for n in sorted(set(gw.store.placement.values()))
              if not any(gw.store.node_of(key) == n for key in first)]
    second, _ = _lose(gw, others[0], at=2.0)
    assert second and staged[0].ctypes.data == fixer._sources.buf.numpy().ctypes.data
    for key, a in kept.items():
        np.testing.assert_array_equal(a, before[key])
        np.testing.assert_array_equal(gw.store.get(key), _expected(objects, key[0])[key[2]])


def test_staging_buffer_made_at_k_blocks_and_grown_only_for_more():
    stage = repair._Staging(pinned=False)
    a = stage.take(3 * Q, least=K * Q)
    assert a.numel() == 3 * Q and stage.buf.numel() == K * Q
    buf = stage.buf
    stage.take(K * Q)
    assert stage.buf is buf
    stage.take(8 * Q)
    assert stage.buf.numel() == 8 * Q


def test_plan_span_and_codec_bytes_recorded_only_when_traced():
    gw, _objects = _gateway()
    node = _busiest(gw.store)
    with profile(activities=[ProfilerActivity.CPU]):
        keys, report = _lose(gw, node)
    steps = sum(r.schedule.count("G") for r in report.repair_reports if r.blocks_repaired)
    groups = {key[0] for key in keys}
    m = report.metrics
    assert steps == len(groups) == len(keys)
    assert m.counter_total("host_calls", span="repair.plan") == steps
    assert m.counter_total("host_bytes", span="repair.plan") == len(keys) * Q
    done = [(r.blocks_fetched, r.bytes_fetched, r.blocks_repaired, r.schedule)
            for r in report.repair_reports if r.blocks_repaired]
    assert done == [(K, K * Q, 1, "Gx1")] * steps

    gw2, _ = _gateway()
    _keys, plain = _lose(gw2, node)
    assert plain.metrics.counter_total("host_calls", span="repair.plan") == 0
    assert [(r.blocks_fetched, r.bytes_fetched, r.blocks_repaired, r.schedule)
            for r in plain.repair_reports if r.blocks_repaired] == done
