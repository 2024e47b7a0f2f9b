#!/usr/bin/env python3
"""Offered rate against tail latency and backlog for an open-loop cell,
to find the highest rate the program sustains on the card (the knee):

    python portbench/knee.py --workload core963-1mib-ycsb-b --seed 1 \\
        --seconds 10 --rates 20 40 60 80 100

One set-up, then one window per rate, in the order given, each with the
cell's traffic at that rate. For each rate one JSON line: requests,
p50 and p95 in ms (from due to the return of the serve call that
carried the request), the last tenth's median lateness of the generator
(how far behind schedule requests were handed to serve) and the drain
(wall time past the window's end until the last request was served).
A rate is sustained while the backlog does not grow through the window
(the drain stays under a second and the last tenth's lateness under a
quarter of a second) and the p95 meets the cell's latency limit
(``p95_limit_ms`` in its workload file). The last line names the knee,
the highest rate below the first that is not sustained (rates taken in
increasing order), and four fifths of it, the rate a cell below the
knee offers.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"


def sustained(point: dict, p95_limit_ms: float = math.inf) -> bool:
    return (point["drain_s"] < 1.0 and point["late_tail_s"] < 0.25
            and point["p95_ms"] <= p95_limit_ms)


def summarize(ops, seconds: float, window_s: float, rate: float) -> dict:
    lat = sorted(op.done - op.due if op.ok else math.inf for op in ops)
    tail = sorted(op.issued - op.due for op in ops[-max(1, len(ops) // 10):])
    return {"rate": rate, "requests": len(ops), "failed": sum(not op.ok for op in ops),
            "p50_ms": lat[len(lat) // 2] * 1e3, "p95_ms": lat[math.ceil(0.95 * len(lat)) - 1] * 1e3,
            "late_tail_s": tail[len(tail) // 2], "drain_s": max(0.0, window_s - seconds)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import contextlib

    import torch

    from portbench import bench, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    _entry, config, workload = spec.cell(spec.load(ROOT), args.workload, ROOT)
    if workload["loop"] != "open":
        print(f"{args.workload} is no open-loop cell", file=sys.stderr)
        return 2
    cell = bench.Cell(args.workload, config, workload, args.seed % 2**63, "cuda", CACHE)
    cell.warm()
    print(json.dumps({"setup_s": time.perf_counter() - _STARTED}), flush=True)
    best, failed = None, False
    for rate in sorted(args.rates):
        cell.workload = {**workload, "rate": rate}
        ops, _losses, window_s = cell.window(args.seconds, contextlib.nullcontext)
        point = summarize(ops, args.seconds, window_s, rate)
        point["sustained"] = sustained(point, workload.get("p95_limit_ms", math.inf))
        print(json.dumps(point), flush=True)
        failed = failed or not point["sustained"]
        if not failed:
            best = rate
    print(json.dumps({"knee": best, "cell_rate": None if best is None else 0.8 * best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
