"""The plain reference against the program, byte for byte, on the CPU
(this test imports both; the reference itself imports nothing of the
program)."""

import numpy as np
import pytest
import torch

from portbench.reference import gf256
from portbench.reference.code import CoreCode
from portbench.reference.payload import put_payload
from repro_torch.coding import gf256 as program_gf256
from repro_torch.core.product_code import CoreCode as ProgramCode
from repro_torch.core.product_code import CoreCodec


def test_product_table_is_the_field_of_the_configuration():
    table = gf256.mul_table(0x11B)
    assert np.array_equal(table, program_gf256._MUL_NP)
    inv = gf256.inverse(0x11B)
    assert all(table[a, inv[a]] == 1 for a in range(1, 256))


def test_matrix_inverse():
    rng = np.random.default_rng(0)
    m = rng.integers(1, 256, (5, 5), dtype=np.uint8)
    eye = gf256.mat_mul(m, gf256.mat_inv(m, 0x11B), 0x11B)
    assert np.array_equal(eye, np.eye(5, dtype=np.uint8))


@pytest.mark.parametrize("n,k,t,q", [(9, 6, 3, 4096), (9, 6, 3, 100), (14, 12, 5, 64)])
def test_encoding_equals_the_programs_codec(n, k, t, q):
    rng = np.random.default_rng(n * 100 + q)
    objects = rng.integers(0, 256, (t, k, q), dtype=np.uint8)
    want = CoreCodec(ProgramCode(n, k, t), device="cpu").encode(objects).numpy()
    got = CoreCode(n, k, t, 0x11B).encode_group(torch.from_numpy(objects)).numpy()
    assert np.array_equal(got, want)


def test_scale_in_slabs(monkeypatch):
    monkeypatch.setattr(gf256, "_SLAB", 7)
    x = torch.arange(50, dtype=torch.uint8)
    want = torch.from_numpy(gf256.mul_table(0x11B)[29][x.numpy()])
    assert torch.equal(gf256.scale(29, x, 0x11B), want)


def test_put_payload_is_what_the_gateway_writes():
    from repro_torch.gateway import GatewayConfig, ObjectGateway
    from repro_torch.gateway.workload import Request
    from repro_torch.storage.netmodel import ClusterProfile

    code = ProgramCode(9, 6, 3)
    gw = ObjectGateway(code, ClusterProfile.network_critical(), 60,
                       GatewayConfig(device="cpu", autotune=False, verify=False))
    gw.load_objects(np.random.default_rng(1).integers(0, 256, (6, 6, 256), dtype=np.uint8))
    gw.serve([Request(1.234567, 4, "put")])
    stored = np.stack([gw.store.blocks[("g1", 1, c)] for c in range(6)])
    assert np.array_equal(stored, put_payload(4, 1.234567, 6, 256))
