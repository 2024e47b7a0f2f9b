"""repair.plan_ms_per_GiB (ms/GiB): host wall time in the program's
``repair.plan`` spans (a row family's repair plan and the host's GF(256)
inverse behind each global step's coefficients) over the GiB rebuilt in
the window (traced runs). A program without the span reads None."""

from portbench import hostspans


def read(run):
    return hostspans.ms_per_GiB(run, ["repair.plan"], hostspans.rebuilt_bytes(run))
