"""coalescer.host_copy_ms_per_GiB.get (ms/GiB): host wall time in the
program's ``coalescer.stage`` and ``coalescer.scatter`` spans (the gather
of source tiles into the staging buffer, the copy of each output back
into its op's result) over the GiB of decode output the coalescer
returned in the window (``CoalescerStats.decode_out_bytes``; traced
runs)."""

from portbench import hostspans


def read(run):
    return hostspans.ms_per_GiB(run, ["coalescer.stage", "coalescer.scatter"],
                                hostspans.decode_out_bytes(run))
