"""coalescer.launches_per_GiB.get (launches/GiB): the coalescer's decode
launches in the window over the GiB of decode output asked of it (the
harness's span around its calls)."""


def read(run):
    launches = run.stats_after.get("decode_calls", 0) - run.stats_before.get("decode_calls", 0)
    if not run.decode_out_bytes or not launches:
        return None
    return launches / (run.decode_out_bytes / 2**30)
