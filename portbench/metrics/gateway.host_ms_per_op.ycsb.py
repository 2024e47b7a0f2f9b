"""gateway.host_ms_per_op.ycsb (ms): the harness's wall time inside serve
calls, less the device's busy time inside them (the profiler's), per
request served: the host's share of the serving path."""

from portbench import devtrace


def read(run):
    if run.trace is None or not run.ops:
        return None
    spans = [(s, e) for name, s, e in run.trace.spans if name == "portbench.serve"]
    host = sum(e - s - devtrace.union_s(run.trace.inside(s, e)) for s, e in spans)
    return host / len(run.ops) * 1e3 if spans else None
