"""repair.read_per_rebuilt (ratio): bytes the repairs fetched
(``RepairReport.bytes_fetched``) over the bytes they rebuilt: 3 for
CORE's vertical XOR of t = 3 blocks, 6 for an RS row decode."""


def read(run):
    rebuilt = sum(loss.blocks_repaired for loss in run.losses) * run.block_bytes
    fetched = sum(loss.bytes_fetched for loss in run.losses)
    return fetched / rebuilt if rebuilt else None
