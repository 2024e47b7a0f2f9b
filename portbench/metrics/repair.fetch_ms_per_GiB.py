"""repair.fetch_ms_per_GiB (ms/GiB): host wall time in the program's
``repair.fetch`` spans (``BlockFixer``'s ``np.stack`` of each step's
sources) over the GiB rebuilt in the window (traced runs)."""

from portbench import hostspans


def read(run):
    return hostspans.ms_per_GiB(run, ["repair.fetch"], hostspans.rebuilt_bytes(run))
