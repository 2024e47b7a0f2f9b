"""gateway.sha256_ms_per_GiB.get (ms/GiB): host wall time in the program's
``gateway.sha256`` spans (each served payload's sha256, the oracle's cost
inside the timed path) over the GiB of GET payload served in the window
(traced runs)."""

from portbench import hostspans


def read(run):
    return hostspans.ms_per_GiB(run, ["gateway.sha256"], hostspans.get_bytes(run))
