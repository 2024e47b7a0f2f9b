"""coalescer.copy_ms_per_GiB.get (ms/GiB): device time of the host-device
copies in the traced window over the GiB of decode output asked of the
coalescer. In a GET-only cell every copy is the decode path's."""


def read(run):
    if run.trace is None or not run.decode_out_bytes:
        return None
    start, end = run.trace.window()
    copies = sum(s for name, s in run.trace.time_by_name(start, end, "Memcpy").items())
    return copies * 1e3 / (run.decode_out_bytes / 2**30) if copies else None
