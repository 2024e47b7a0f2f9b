"""get_GiBps (GiB/s): payload bytes of the GETs served in the window,
each judged afterwards against the reference, over the window's whole
wall time (to the return of its last serve call)."""


def read(run):
    gets = [op for op in run.ops if op.kind == "get" and op.ok]
    if not gets or run.window_s <= 0:
        return None
    return len(gets) * run.k * run.block_bytes / run.window_s / 2**30
