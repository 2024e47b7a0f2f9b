"""Shared by tests/test_torch_examples.py and
tests/test_torch_examples_gateway.py: run a torch example
(``examples/torch_<name>.py``) in this process through its ``main(argv)``
with ``--device cpu`` while its reference twin (``examples/<name>.py``)
runs in a subprocess on the JAX package, and compare their standard
output line by line.

A printed number that depends on measured host time is masked on both
sides before the comparison: ``MEASURED`` lists, per example, the
patterns of such lines (a pattern with groups masks those groups, one
without masks every number in the line). That covers what the wall clock
measures directly (``t_cpu``, a repair's compute time, a step's ms, a
save's seconds) and what it decides: the gateway bills a decode launch at
its measured time where no ``decode_cost`` is given, and its autotuner
picks tile widths and chunk sizes by measured sweeps, so the launch
counts and every latency, throughput, cache count and pacing share of
such a serve are measured values. Everything else (blocks fetched, MB,
``verified=``, schedules, served and completed counts, audits, durability,
wrong bytes, repair traffic, overheads) must be equal."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"-?\d+(?:\.\d+)?")

_SERVE = (r"^\s+(?:throughput|latency p50/p99|degraded GETs|ragged decode|block cache|fabric)\s",
          r"^\s+trace\s+(\d+) spans over (\d+) traces -> (\S+)$",
          r"^\s+critical path\s")
MEASURED = {
    "quickstart": (r"t_cpu\s+([\d.]+)s",),
    "degraded_read": (r"t=\s*([\d.]+)s",),
    "repair_scheduling": (),
    "train_tiny_lm": (r"^step\s+\d+\s+loss ([\d.]+)\s+gnorm ([\d.]+)\s+(\d+) ms$",
                      r"^\s+ckpt @ \d+: \d+ CORE groups, [\d.]+ MB, ([\d.]+)s$",
                      r"^loss ([\d.]+) -> ([\d.]+) over",
                      r"digest ([0-9a-f]{16})",
                      r"^resumed to step \d+; loss ([\d.]+)$"),
    "gateway_serving": _SERVE,
    "gateway_serving --trace": _SERVE,
    "gateway_serving --tenants": (r"^\s+latency p50/p99\s", r"^\s+SLO violations\s",
                                  r"^\s+worst fabric queueing\s"),
    "gateway_serving --scenario": (r"^\s+p99 in surge\s", r"^\s+MTTR mean/max\s",
                                   r"^\s+degraded GETs\s", r"^\s+pacing shares\s"),
    "gateway_serving --graybox": (r"^\s+latency p50/p99\s", r"^\s+hedges\s",
                                  r"^\s+extra fabric\s", r"^\s+MTTD mean/max\s",
                                  r"\((\d+) by fetch verify, (\d+) by scrub\)",
                                  r"^\s+degraded GETs\s+(\d+) of"),
    "gateway_serving --bakeoff": (r"^\s+(?:rs|core|lrc)\s+[\d.]+\s+([\d.]+)\s+([\d.]+)\s",),
    "gateway_serving --writes": (r"^\s+PUT throughput\s", r"^\s+ragged encode\s"),
    "gateway_serving --shards": (r"^\s+throughput\s", r"^\s+latency p50/p99\s",
                                 r"^\s+shards speedup\s"),
}


def mask(text: str, patterns) -> list[str]:
    """``text``'s lines with ``patterns``' numbers masked; a masked line's
    runs of spaces (a padded column's width) as one."""
    out = []
    for line in text.splitlines():
        masked = line
        for pat in patterns:
            m = re.search(pat, masked)
            if m is None:
                continue
            if m.re.groups:
                for i in range(m.re.groups, 0, -1):  # right to left: spans stay valid
                    masked = masked[: m.start(i)] + "#" + masked[m.end(i):]
            else:
                masked = NUMBER.sub("#", masked)
        out.append(line if masked == line else " ".join(masked.split()))
    return out


def load_example(name: str):
    """``examples/<name>.py`` as a module (not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def start_reference(name: str, args) -> subprocess.Popen:
    """The reference twin in a subprocess on the JAX package's CPU
    backend, its autotune cache off."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", REPRO_AUTOTUNE_CACHE="off")
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def run_torch(name: str, args) -> str:
    """``examples/torch_<name>.py``'s ``main`` on the CPU in this process;
    its standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        load_example(f"torch_{name}").main([*args, "--device", "cpu"])
    return buf.getvalue()


def finish(proc: subprocess.Popen, timeout: float = 240) -> str:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out


def assert_twins_agree(key: str, ref: str, got: str) -> None:
    want, have = mask(ref, MEASURED[key]), mask(got, MEASURED[key])
    assert len(want) == len(have), (ref, got)
    for i, (w, h) in enumerate(zip(want, have)):
        assert h == w, f"line {i}: torch {h!r} != reference {w!r}"
