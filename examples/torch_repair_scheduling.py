"""Repair scheduling live on the PyTorch port: the paper's Step and Plus
failure patterns (§6.3, Table 1) scheduled with row-first /
column-first / RGS, printing each schedule and its cost (the twin of
examples/repair_scheduling.py on ``repro_torch``). The schedulers are
host code; ``--device`` is taken as every example takes it: the card by
default (raising without one), ``cpu`` when named.

    PYTHONPATH=src python examples/torch_repair_scheduling.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.failure_matrix import (
    independent_clusters,
    plus_pattern,
    step_pattern,
)
from repro_torch.core.product_code import CoreCode
from repro_torch.core.recoverability import (
    irrecoverability_lower_bound,
    is_recoverable,
    recoverability_upper_bound,
)
from repro_torch.core.scheduling import SCHEDULERS
from repro_torch.kernels.backend import resolve_device


def show(code: CoreCode, name: str, fm: np.ndarray):
    print(f"--- {name} pattern ({int(fm.sum())} failures) ---")
    for r in range(fm.shape[0]):
        print("   ", "".join("X" if x else "." for x in fm[r]))
    print(f"  clusters: {len(independent_clusters(fm))}, "
          f"recoverable: {is_recoverable(code, fm)}")
    for sched_name, fn in SCHEDULERS.items():
        s = fn(code, fm)
        print(f"  {sched_name:13s} cost {s.traffic:3d} blocks   plan: {s.describe()}")
    print()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    resolve_device(ap.parse_args(argv).device)

    code = CoreCode(14, 12, 5)
    print(f"code ({code.n},{code.k},{code.t}); irrecoverability bounds "
          f"L={irrecoverability_lower_bound(code)}, "
          f"U={recoverability_upper_bound(code)}\n")
    show(code, "Step", step_pattern(code.rows, code.n))
    show(code, "Plus", plus_pattern(code.rows, code.n))

    # a random heavy pattern: partial recovery via independent clusters
    rng = np.random.default_rng(7)
    fm = (rng.random((code.rows, code.n)) < 0.12)
    show(code, "random p=0.12", fm)


if __name__ == "__main__":
    main()
