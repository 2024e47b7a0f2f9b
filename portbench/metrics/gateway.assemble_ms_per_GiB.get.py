"""gateway.assemble_ms_per_GiB.get (ms/GiB): host wall time in the
program's ``gateway.assemble`` spans (``np.stack`` of each GET's fetched
and decoded blocks into its payload) over the GiB of GET payload served
in the window (traced runs)."""

from portbench import hostspans


def read(run):
    return hostspans.ms_per_GiB(run, ["gateway.assemble"], hostspans.get_bytes(run))
