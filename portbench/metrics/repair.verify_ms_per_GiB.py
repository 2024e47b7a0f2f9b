"""repair.verify_ms_per_GiB (ms/GiB): host wall time in the program's
``repair.verify`` spans (the crc32 of every stored block of each group a
repair touches) over the GiB rebuilt in the window (traced runs)."""

from portbench import hostspans


def read(run):
    return hostspans.ms_per_GiB(run, ["repair.verify"], hostspans.rebuilt_bytes(run))
