"""gateway.fetch_ms_per_GiB.get (ms/GiB): host wall time in the program's
``gateway.fetch`` spans (each GET's ``store.get``, crc32 verify and fabric
booking of its blocks) over the GiB of GET payload served in the window
(traced runs)."""

from portbench import hostspans


def read(run):
    return hostspans.ms_per_GiB(run, ["gateway.fetch"], hostspans.get_bytes(run))
