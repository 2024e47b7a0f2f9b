"""Twin of tests/test_launch_integration.py: the port's launchers in
subprocesses. The sharded training case runs 4 gloo rank processes on
the CPU (``--device cpu``) on a 2 x 2 mesh, with a CORE checkpoint at
step 2; the serve case re-runs the reference's serve command on the CPU.
The reference's dry-run case waits for the port's dry run."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


def _run(args, timeout=300):
    return subprocess.run(
        [sys.executable, *args], env=ENV, cwd=ROOT, timeout=timeout,
        capture_output=True, text=True,
    )


def test_sharded_training_on_2x2_mesh():
    r = _run([
        "-m", "repro_torch.launch.train", "--arch", "qwen2_72b", "--reduced",
        "--steps", "3", "--devices", "4", "--mesh", "2x2",
        "--seq-len", "32", "--global-batch", "4", "--ckpt-every", "2",
        "--device", "cpu",
    ])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "done at step 3" in r.stdout, r.stdout
    lines = r.stdout.splitlines()
    # rank 0 alone prints: one line per checkpoint (steps 2 and 3), one done
    assert [line.split(":")[0].strip() for line in lines if "ckpt @" in line] == [
        "ckpt @ 2", "ckpt @ 3"]
    assert sum(line.startswith("done at step") for line in lines) == 1


def test_serve_loop_reduced():
    r = _run([
        "-m", "repro_torch.launch.serve", "--arch", "olmoe_1b_7b", "--reduced",
        "--requests", "3", "--batch", "2", "--prompt-len", "8",
        "--max-new", "4", "--cache-len", "32", "--device", "cpu",
    ])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "served 3 requests" in r.stdout, r.stdout
