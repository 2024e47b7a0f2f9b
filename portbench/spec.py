"""Finding a cell's files by name.

``BENCHMARK.json`` names the cells, configurations and metrics. Each
has a file of its own, found by name, so a later change adds a cell, a
deployment or a metric by adding files and entries, never by editing
one:

- a configuration: the ``file`` its ``configs`` entry names;
- a cell's traffic: ``portbench/workloads/<cell>.json``;
- a metric: ``portbench/metrics/<metric>.py``, or, where there is no
  such file, the file of its name less the last dotted part (one
  ``device.idle_pct.py`` reads ``device.idle_pct.get`` and
  ``device.idle_pct.repair``); its ``read(run)`` returns the number or
  None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "portbench"


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str, root: pathlib.Path = ROOT) -> tuple[dict, dict, dict]:
    """(the ``workloads`` entry, the configuration, the traffic) of cell ``name``."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell named {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    workload = json.loads((root / "portbench" / "workloads" / f"{name}.json").read_text())
    if workload["traffic"] != entry["traffic"]:
        raise ValueError(f"{name}: the workload file's traffic {workload['traffic']!r} is not "
                         f"the cell's {entry['traffic']!r}")
    return entry, config, workload


def metrics_for(spec: dict, name: str, trace: bool) -> list[dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end ones
    untraced, its per-layer ones traced. A metric with a ``workloads``
    list is reported in those cells; a per-layer metric without one in
    every cell that reports the end-to-end metric it ``moves``."""
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def reader_path(metric: str, root: pathlib.Path = ROOT) -> pathlib.Path:
    """``portbench/metrics/<metric>.py``, or the file of ``metric`` less its
    last dotted part where that has none."""
    metrics = root / "portbench" / "metrics"
    path = metrics / f"{metric}.py"
    stem = metrics / f"{metric.rpartition('.')[0]}.py"
    return stem if not path.is_file() and "." in metric and stem.is_file() else path


def reader(metric: str, root: pathlib.Path = ROOT):
    """The ``read`` function of ``metric``'s file (``path``)."""
    path = reader_path(metric, root)
    mod_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
