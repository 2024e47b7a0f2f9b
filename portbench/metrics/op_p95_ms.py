"""op_p95_ms (ms): the 95th percentile (nearest rank), over every request
due in the window, GETs and PUTs together, of the wall time from when it
was due to when the serve call that carried it returned. A request that
failed or was refused counts as missing: it ranks above every served
one."""

import math


def read(run):
    if not run.ops:
        return None
    lat = sorted(op.done - op.due if op.ok else math.inf for op in run.ops)
    value = lat[math.ceil(0.95 * len(lat)) - 1]
    return value * 1e3 if math.isfinite(value) else None
