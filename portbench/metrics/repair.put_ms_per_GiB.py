"""repair.put_ms_per_GiB (ms/GiB): host wall time in the program's
``repair.put`` spans (``store.put_block`` of each rebuilt block, its
crc32 included) over the GiB rebuilt in the window (traced runs)."""

from portbench import hostspans


def read(run):
    return hostspans.ms_per_GiB(run, ["repair.put"], hostspans.rebuilt_bytes(run))
