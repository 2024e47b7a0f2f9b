"""repair.device_wait_ms_per_GiB (ms/GiB): host wall time in the
program's ``repair.codec`` spans (the sources' copy to the device, the
codec, the rebuilt block's copy back, the host blocked throughout) over
the GiB rebuilt in the window (traced runs)."""

from portbench import hostspans


def read(run):
    return hostspans.ms_per_GiB(run, ["repair.codec"], hostspans.rebuilt_bytes(run))
