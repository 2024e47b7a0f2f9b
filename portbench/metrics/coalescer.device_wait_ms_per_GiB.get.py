"""coalescer.device_wait_ms_per_GiB.get (ms/GiB): host wall time in the
program's ``coalescer.launch`` and ``coalescer.d2h`` spans (the host
blocked on the copy in, the kernel and the copy out) over the GiB of
decode output the coalescer returned in the window
(``CoalescerStats.decode_out_bytes``; traced runs)."""

from portbench import hostspans


def read(run):
    return hostspans.ms_per_GiB(run, ["coalescer.launch", "coalescer.d2h"],
                                hostspans.decode_out_bytes(run))
