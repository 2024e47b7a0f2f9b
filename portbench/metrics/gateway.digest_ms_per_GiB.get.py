"""gateway.digest_ms_per_GiB.get (ms/GiB): host wall time from the start
of each served GET payload's assembly to the end of its sha256 (the
harness's span around ``_assemble_payload`` and the hash, traced runs
only) over the GiB of GET payload served in the window. The digest is
the oracle's cost inside the timed path: this reading tells a faster
digest from a faster decode."""


def read(run):
    served = sum(op.kind == "get" and op.ok for op in run.ops) * run.k * run.block_bytes
    if not run.digest_s or not served:
        return None
    return run.digest_s * 1e3 / (served / 2**30)
