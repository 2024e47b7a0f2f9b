"""planner.blocks_read_per_degraded_get (blocks): source blocks the
planner's reconstructions read per degraded GET in the window, from the
gateway's own counts (the paper's Table 1: t = 3 by the vertical XOR
against k = 6 by an RS row decode)."""


def read(run):
    gets = sum(r.metrics.counter_total("degraded_gets") for r in run.reports)
    blocks = sum(r.metrics.counter_total("degraded_recon_blocks") for r in run.reports)
    return blocks / gets if gets else None
