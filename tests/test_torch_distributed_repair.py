"""Twin of tests/test_distributed_repair.py: the XOR butterfly across the
ranks of a mesh equals the numpy XOR, byte for byte.

The reference runs 8 fake devices in one process; the port's ranks are
processes, so one subprocess spawns 8 gloo ranks on the CPU (a file
rendezvous, a timeout on the subprocess and on the process group) and
runs the reference's three cases, plus the butterfly along one axis of a
(2, 4) mesh and on a mesh over the even ranks alone."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r"""
import os, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, world, rdv):
    torch.set_num_threads(1)
    from repro_torch.core.distributed import distributed_xor_repair
    from repro_torch.launch.mesh import init_ranks, make_mesh

    init_ranks(rank, world, rdv, "cpu", timeout_s=120)
    try:
        for t, q in [(8, 4096), (5, 1000), (3, 257)]:
            mesh = make_mesh((8,), ("data",), device="cpu")
            rng = np.random.default_rng(t)
            blocks = rng.integers(0, 256, (t, q), dtype=np.uint8)
            want = np.bitwise_xor.reduce(blocks, axis=0)
            got = distributed_xor_repair(torch.from_numpy(blocks), mesh, "data")
            assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want), (t, q)
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        blocks = np.random.default_rng(9).integers(0, 256, (4, 300), dtype=np.uint8)
        got = distributed_xor_repair(blocks, mesh, "model")
        assert np.array_equal(got.numpy(), np.bitwise_xor.reduce(blocks, axis=0))
        # a mesh over some ranks (the reference's ``devices``): the even ones
        mesh = make_mesh((4,), ("data",), devices=[0, 2, 4, 6], device="cpu")
        if rank % 2 == 0:
            got = distributed_xor_repair(blocks[:3], mesh, "data")
            assert np.array_equal(got.numpy(), np.bitwise_xor.reduce(blocks[:3], axis=0))
        if rank == 0:
            print("DISTRIBUTED_XOR_OK", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(run, args=(8, "file://" + os.path.join(tmp, "rdv")), nprocs=8)
"""


def test_distributed_xor_repair_subprocess(tmp_path):
    script = tmp_path / "xor_ranks.py"
    script.write_text(SCRIPT)
    r = subprocess.run(
        [sys.executable, str(script)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"},
        cwd=ROOT, timeout=300, capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "DISTRIBUTED_XOR_OK" in r.stdout


def test_critical_path_model():
    from repro_torch.core.distributed import xor_repair_critical_path

    bfly, cent = xor_repair_critical_path(5, 64 << 20, 50e9, 12e6)
    assert bfly < cent / 100  # mesh repair crushes 2013-Ethernet repair
    b2, c2 = xor_repair_critical_path(5, 4 << 20, 50e9, 50e9)
    assert b2 == pytest.approx(3 * (4 << 20) / 50e9)
    assert c2 == pytest.approx(5 * (4 << 20) / 50e9)


@pytest.mark.parametrize("n", [3, 6, 12])
def test_non_power_of_two_axis_raises(n):
    """The reference pairs coordinate i with i ^ 2^r, out of range on an
    axis of n ranks that is not a power of two: the port refuses it
    before it sends anything."""
    from repro_torch.core.distributed import distributed_xor_repair

    mesh = types.SimpleNamespace(mesh_dim_names=("data",), size=lambda dim: n)
    with pytest.raises(ValueError, match="not a power of two"):
        distributed_xor_repair(torch.zeros((n, 16), dtype=torch.uint8), mesh, "data")
