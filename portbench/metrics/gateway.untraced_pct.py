"""gateway.untraced_pct (%): the share of the program's serve time that no
child span covers: the ``gateway.serve`` span's self time over its
inclusive time, summed over the window's serve calls (traced runs). One
file reads ``gateway.untraced_pct.get`` and ``gateway.untraced_pct.repair``."""

from portbench import hostspans


def read(run):
    total = hostspans.seconds(run, "gateway.serve")
    if not total:
        return None
    return hostspans.seconds(run, "gateway.serve", counter="host_self_s") / total * 100
