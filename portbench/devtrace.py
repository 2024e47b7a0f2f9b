"""Reduction of a profiler trace to the benchmark's device numbers.

A trace here is plain data: the device's activities as (name, start,
end) in seconds, and the harness's own spans (``portbench.*`` user
annotations) as (name, start, end) on the same clock. ``from_profiler``
makes one from a ``torch.profiler.profile``; the tests make them by hand.

The arithmetic (the union of the device's intervals, the idle gaps, the
time by operation) follows ``chip_smoke.py``'s ``serve_full_width``
(busy share = device time over the serve wall), measured here over the
traced window instead of summed per operation: copies and kernels can
overlap, and a union does not count the overlap twice.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

COPY_PREFIXES = ("Memcpy", "Memset")


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


@dataclass
class Trace:
    device: list[tuple[str, float, float]] = field(default_factory=list)
    spans: list[tuple[str, float, float]] = field(default_factory=list)

    def window(self) -> tuple[float, float]:
        """The traced window: the ``portbench.window`` span."""
        for name, start, end in self.spans:
            if name == "portbench.window":
                return start, end
        raise ValueError("the trace has no portbench.window span")

    def inside(self, start: float, end: float, kinds: str = "all") -> list[tuple[float, float]]:
        """Device intervals clipped to [start, end]; ``kinds`` is ``all``,
        ``kernels`` (copies and memsets left out) or ``copies``."""
        out = []
        for name, s, e in self.device:
            if kinds == "kernels" and is_copy(name):
                continue
            if kinds == "copies" and not is_copy(name):
                continue
            s, e = max(s, start), min(e, end)
            if e > s:
                out.append((s, e))
        return out

    def busy_s(self, start: float, end: float, kinds: str = "all") -> float:
        return union_s(self.inside(start, end, kinds))

    def time_by_name(self, start: float, end: float, prefix: str = "") -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            s, e = max(s, start), min(e, end)
            if e > s and name.startswith(prefix):
                out[name] += e - s
        return dict(out)


def union_s(intervals: list[tuple[float, float]]) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(trace: Trace, start: float, end: float) -> list[tuple[str, float]]:
    """The device's idle time in [start, end], summed by what the host was
    doing: the innermost harness span around the gap's middle and the
    device operation the gap follows."""
    events = sorted((s, e, name) for name, s, e in trace.device if e > start and s < end)
    gaps: dict[str, float] = defaultdict(float)
    cursor, last = start, "window start"
    for s, e, name in events:
        if s > cursor:
            gaps[_label(trace, (cursor + s) / 2, last)] += s - cursor
        if e > cursor:
            cursor, last = e, name
    if end > cursor:
        gaps[_label(trace, (cursor + end) / 2, last)] += end - cursor
    return sorted(gaps.items(), key=lambda kv: -kv[1])


def _label(trace: Trace, at: float, after: str) -> str:
    inner = None
    for name, s, e in trace.spans:
        if s <= at <= e and name != "portbench.window":
            if inner is None or e - s < inner[2] - inner[1]:
                inner = (name, s, e)
    span = inner[0].removeprefix("portbench.") if inner else "harness"
    return f"{span} after {after[:60]}"


def breakdown(trace: Trace, start: float, end: float, top: int = 10) -> dict:
    ops = sorted(trace.time_by_name(start, end).items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in idle_gaps(trace, start, end)[:top]]}


def from_profiler(prof) -> Trace:
    """The device activities and the ``portbench.*`` spans of a finished
    ``torch.profiler.profile``, from its kineto events."""
    from torch.autograd import DeviceType

    trace = Trace()
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e9
        end = start + ev.duration_ns() / 1e9
        if ev.name().startswith("portbench."):
            # a user annotation shows on the host and again on the
            # device's annotation track: the host's is the span
            if ev.device_type() != DeviceType.CUDA:
                trace.spans.append((ev.name(), start, end))
        elif ev.device_type() == DeviceType.CUDA:
            trace.device.append((ev.name(), start, end))
    return trace
