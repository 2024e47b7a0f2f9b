#!/usr/bin/env python3
"""Sound runs beside the control and the planted faults, at a cell's own
size, on several seeds, in one process (the benchmark's own runs never
run this):

    python portbench/control.py --workload <cell> --seconds 10 --seeds 1 2 3 \\
        --faults none zero_fill

``none`` is the sound program; ``zero_fill`` is the control, and
``answer``, ``unchanged`` and ``half`` the faults of ``faults.py``. One
JSON line each: the seed, the fault, ``correct`` and every number
compared beside its limit.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", default=["none", "zero_fill"])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import bench, faults

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for name in args.faults:
            fault = None if name == "none" else faults.FAULTS[name]
            r = bench.run_cell(args.workload, seed, args.seconds, False, device="cuda",
                               cache_dir=CACHE, started=time.perf_counter(), root=ROOT,
                               fault=fault)
            print(json.dumps({"workload": args.workload, "seed": seed, "fault": name,
                              "correct": r["correct"], "attempted": r["attempted"],
                              "failed": r["failed"], "metrics": r["metrics"],
                              "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
