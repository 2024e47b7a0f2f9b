#!/usr/bin/env python3
"""The benchmark's one command, run from the root of a checkout:

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It serves the cell's traffic through ``repro_torch`` (``src/`` is put on
the path here) on one CUDA card for ``--seconds`` of wall clock, judges
what the program produced against the plain reference, prints each
number compared beside its limit as the last lines of standard error,
and prints one JSON object as the last line of standard output. It
exits non-zero, printing no result, without the card the cell asks
for, without the program, or when JAX or the JAX package got loaded.
Every cache it or the program writes lies under ``build/`` in the
checkout.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches of the toolchains a kernel of the program may use, at
    # fixed paths inside the checkout (the autotune cache: ``bench.Cell``)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import bench, spec

    entry, _config, _workload = spec.cell(spec.load(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = bench.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            device="cuda", cache_dir=CACHE, started=_STARTED, root=ROOT)
    found = bench.forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
