"""Twin of tests/test_launch_integration.py: the port's launchers in
subprocesses. The sharded training case runs 4 gloo rank processes on
the CPU (``--device cpu``) on a 2 x 2 mesh, with a CORE checkpoint at
step 2; the serve case re-runs the reference's serve command on the CPU.
The dry-run case runs the port's dry run on the reference's cell
(falcon_mamba_7b, decode_32k, 2 x 2 mesh, a fake world of 4 ranks); then
both packages' dry runs write the records of falcon-mamba-7b's train_4k,
prefill_32k and decode_32k cells on that mesh, which are held to each
other: the argument bytes a rank equal for all three, the output bytes
equal for prefill and decode, ``model_flops_global`` equal, the traced
flops a rank within 5% of the compiled ones for prefill and decode (the
train cell's ratio is printed), and ``benchmarks/roofline_report.py``
reads the port's records."""

from __future__ import annotations

import json
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


def test_dryrun_cell_on_debug_mesh():
    r = _run([
        "-m", "repro_torch.launch.dryrun", "--arch", "falcon_mamba_7b",
        "--shape", "decode_32k", "--mesh", "2x2", "--devices", "4", "--device", "cpu",
    ])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "bound=" in r.stdout and "TracedMemoryStats" in r.stdout


FALCON_CELLS = ("train_4k", "prefill_32k", "decode_32k")


@pytest.fixture(scope="module")
def dryrun_records(tmp_path_factory):
    """Both packages' records of falcon-mamba-7b's cells on the 2 x 2
    mesh, the two dry runs in parallel subprocesses."""
    tmp = tmp_path_factory.mktemp("dryrun")
    jax_env = {**ENV, "JAX_PLATFORMS": "cpu"}
    common = ["--arch", "falcon_mamba_7b", "--shape", "all", "--mesh", "2x2", "--devices", "4"]
    procs = {
        "port": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *common, "--device", "cpu",
             "--out", str(tmp / "port")], env=ENV, cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
        "ref": subprocess.Popen(
            [sys.executable, "-m", "repro.launch.dryrun", *common, "--out", str(tmp / "ref")],
            env=jax_env, cwd=ROOT, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT),
    }
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}:\n{out[-6000:]}"
    return tmp, {
        shape: tuple(json.loads((tmp / pkg / f"falcon_mamba_7b.{shape}.2x2.json").read_text())
                     for pkg in ("port", "ref"))
        for shape in FALCON_CELLS}


@pytest.mark.parametrize("shape", FALCON_CELLS)
def test_dryrun_record_matches_reference(dryrun_records, shape):
    port, ref = dryrun_records[1][shape]
    assert port["arg_bytes_per_chip"] == ref["arg_bytes_per_chip"]
    assert port["model_flops_global"] == ref["model_flops_global"]
    assert (port["kind"], port["strategy"], port["num_devices"]) == (ref["kind"], "2d", 4)
    ratio = port["flops_per_chip"] / ref["flops_per_chip"]
    print(f"{shape}: traced / compiled flops a rank {ratio:.4f}")
    if shape != "train_4k":
        assert port["out_bytes_per_chip"] == ref["out_bytes_per_chip"]
        assert abs(ratio - 1) < 0.05, ratio
    assert port["peak_mem_bytes"] >= port["arg_bytes_per_chip"]
    assert port["wire_bytes_per_chip"] > 0 and port["coll_count"] > 0


def test_roofline_report_reads_the_port_records(dryrun_records):
    tmp = dryrun_records[0]
    r = _run(["-m", "benchmarks.roofline_report", "--dir", str(tmp / "port"), "--mesh", "2x2"])
    assert r.returncode == 0, r.stdout + r.stderr
    rows = [line for line in r.stdout.splitlines() if line.startswith("| falcon_mamba_7b")]
    assert len(rows) == 4, r.stdout
