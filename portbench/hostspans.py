"""The program's host spans (``repro_torch.obs.host``) as the metric
readers see them: the counters ``host_s``, ``host_self_s`` and
``host_calls`` of each span, summed over the window's
``GatewayReport``s. A program that records no spans (an untraced run,
or a program without them) reads None."""

from __future__ import annotations


def total(run, counter: str, spans) -> float:
    return sum(r.metrics.counter_total(counter, span=s) for r in run.reports for s in spans)


def seconds(run, *spans, counter: str = "host_s") -> float | None:
    """The window's seconds in ``spans`` (inclusive, or ``host_self_s``),
    None where no report recorded a call of them."""
    if not total(run, "host_calls", spans):
        return None
    return total(run, counter, spans)


def ms_per_GiB(run, spans, nbytes) -> float | None:
    """Milliseconds in ``spans`` per GiB of ``nbytes``."""
    s = seconds(run, *spans)
    if s is None or not nbytes:
        return None
    return s * 1e3 / (nbytes / 2**30)


def get_bytes(run) -> int:
    """Payload bytes of the GETs served in the window."""
    return sum(op.kind == "get" and op.ok for op in run.ops) * run.k * run.block_bytes


def decode_out_bytes(run) -> int | None:
    """Bytes of decode output the coalescer returned in the window, by
    its own counter (``CoalescerStats.decode_out_bytes``)."""
    after = run.stats_after.get("decode_out_bytes")
    if after is None:
        return None
    return after - run.stats_before.get("decode_out_bytes", 0)


def rebuilt_bytes(run) -> int:
    """Bytes of the lost blocks rebuilt in the window."""
    return sum(loss.blocks_repaired for loss in run.losses) * run.block_bytes
