"""Faults planted under the timed path, for the control and the tests.

Each is a function of the gateway, applied after set-up, that breaks
one guarantee of the deployment in the program's place:

- ``zero_fill`` (the control): every reconstruction, encode and rebuilt
  block comes out as zeros, the store that gives up on its code;
- ``answer``: one byte of each reconstruction, encode and rebuilt block
  is altered where it is produced;
- ``unchanged``: a step returns its state unchanged: a reconstruction
  returns its first source, a PUT's encode window writes nothing, a
  repair rebuilds nothing;
- ``half``: each serve call gets only half of its requests, and a
  repair only half of its groups.
"""

from __future__ import annotations

import numpy as np


def _outputs(gw, change) -> None:
    """Pass every coalescer output and every block the fixer rebuilds
    through ``change(op, array) -> array``."""
    co = gw.coalescer
    for name in ("execute", "execute_encode"):
        inner = getattr(co, name)

        def wrapped(ops, fetch, inner=inner):
            results, units = inner(ops, fetch)
            return [{c: change(op, fetch, a) for c, a in r.items()}
                    for op, r in zip(ops, results)], units

        setattr(co, name, wrapped)
    measure = gw.fixer._measure
    gw.fixer._measure = lambda fn, *args: change(None, None, measure(fn, *args))


def _flip(a: np.ndarray) -> np.ndarray:
    a = np.array(a, copy=True)
    a.reshape(-1)[0] ^= 0xFF
    return a


def zero_fill(gw) -> None:
    _outputs(gw, lambda op, fetch, a: np.zeros_like(a))


def answer(gw) -> None:
    _outputs(gw, lambda op, fetch, a: _flip(a))


def unchanged(gw) -> None:
    from repro_torch.storage.repair import RepairReport

    _outputs(gw, lambda op, fetch, a: (np.array(fetch(op.sources[0]), copy=True)
                                       if op is not None and op.kind in ("H", "V") else a))
    gw._encode_window = lambda jobs, seals, report: None
    gw.fixer.fix_group = lambda group_id, rows=None: RepairReport(mode="core")


def half(gw) -> None:
    from repro_torch.storage.repair import RepairReport

    serve = gw.serve
    gw.serve = lambda requests, failures=None: serve(list(requests)[::2], failures)
    # a repair's batch is its groups: every other one is left out
    fix, calls = gw.fixer.fix_group, [0]

    def fix_half(group_id, rows=None):
        calls[0] += 1
        return fix(group_id, rows) if calls[0] % 2 else RepairReport(mode="core")

    gw.fixer.fix_group = fix_half


FAULTS = {"zero_fill": zero_fill, "answer": answer, "unchanged": unchanged, "half": half}
