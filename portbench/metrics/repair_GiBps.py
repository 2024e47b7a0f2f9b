"""repair_GiBps (GiB/s): bytes of the lost blocks rebuilt in the window
over the window's whole wall time (to the end of its last repair)."""


def read(run):
    if not run.losses or run.window_s <= 0:
        return None
    rebuilt = sum(loss.blocks_repaired for loss in run.losses) * run.block_bytes
    return rebuilt / run.window_s / 2**30 if rebuilt else None
