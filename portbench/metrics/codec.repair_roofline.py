"""codec.repair_roofline (%): the least time the window's repairs take at
HBM bandwidth, reading their sources and writing the rebuilt blocks once
((fetched + rebuilt) bytes), over the device time of all kernels in the
traced window (copies left out)."""

from portbench import peaks


def read(run):
    if run.trace is None or not run.losses:
        return None
    moved = sum(loss.bytes_fetched + loss.blocks_repaired * run.block_bytes
                for loss in run.losses)
    start, end = run.trace.window()
    kernels = run.trace.busy_s(start, end, "kernels")
    if not moved or kernels <= 0:
        return None
    return moved / peaks.HBM_BYTES_PER_S / kernels * 100
