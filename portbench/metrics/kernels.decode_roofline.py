"""kernels.decode_roofline (%): the least time the window's decode work
takes at HBM bandwidth over the device time of all kernels in the traced
window (copies left out). The work is counted by the benchmark from the
coalescer's counts: each reconstruction reads its sources and writes
its output once, (sources + 1) x block bytes (an RS op with several
targets is counted with one output: the count never runs high). Any
kernel that does this work is timed, whatever its name."""

from portbench import peaks


def read(run):
    if run.trace is None:
        return None
    ops = srcs = 0
    for kind in ("H", "V"):
        ops += (run.stats_after["ops_by_kind"].get(kind, 0)
                - run.stats_before["ops_by_kind"].get(kind, 0))
        srcs += (run.stats_after["sources_by_kind"].get(kind, 0)
                 - run.stats_before["sources_by_kind"].get(kind, 0))
    start, end = run.trace.window()
    kernels = run.trace.busy_s(start, end, "kernels")
    if not ops or kernels <= 0:
        return None
    return (srcs + ops) * run.block_bytes / peaks.HBM_BYTES_PER_S / kernels * 100
