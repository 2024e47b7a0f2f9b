"""Spans over the simulated clock.

A ``Span`` is a named interval ``[start, end]`` in simulated seconds,
tied to a request (or repair) by ``trace_id``, nested under a parent by
``parent_id``, and placed on a display *track* — a ``(group, name)``
pair like ``("tenant", "gold")`` or ``("engine", "engine3")`` that the
Perfetto exporter turns into process/thread rows.

The ``Tracer`` is deliberately dumb and bounded:

  * spans for an in-flight trace stage in a per-trace dict;
  * ``end_trace(trace_id, latency)`` applies the sampling policy and
    either commits the trace's spans into a ring buffer
    (``deque(maxlen=capacity)``) or drops them;
  * sampling policies compose from a spec string —
    ``"always"``, ``"head:N"`` (first N traces), ``"tail:SECONDS"``
    (keep any trace at least that slow — slow requests are never
    dropped), comma-joined meaning keep-if-ANY-matches, e.g.
    ``"head:50,tail:0.1"``.

Emission sites throughout the stack guard on ``tracer.enabled`` and are
observation-only: a tracer never changes event ordering, payload bytes,
or any simulated timestamp. ``NULL_TRACER`` is the shared disabled
instance the gateway threads through when tracing is off, so call sites
never branch on ``None``.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field


@dataclass(slots=True)
class Span:
    """One named interval on the simulated clock."""

    name: str
    start: float
    end: float
    trace_id: int
    span_id: int
    parent_id: int | None = None
    track: tuple[str, str] = ("gateway", "main")
    attrs: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start


class Tracer:
    """Bounded ring-buffer span collector with trace-level sampling.

    Emission is the hot path (one call per transfer on a traced run), so
    spans are staged and committed as plain TUPLES; ``Span`` objects are
    materialized lazily — and cached per commit epoch — the first time
    ``.spans`` is read at analysis/export time. The serve loop never
    pays for object construction it isn't going to look at.
    """

    def __init__(self, sample: str = "always", capacity: int = 65536):
        self.enabled = True
        self.capacity = capacity
        self._spans: deque[tuple] = deque(maxlen=capacity)
        self._staged: dict[int, list[tuple]] = {}
        self._ids = itertools.count(1)
        self._epoch = 0  # bumped on every commit; keys the .spans cache
        self._cache: tuple[int, list[Span]] | None = None
        self.traces_started = 0
        self.traces_kept = 0
        self.traces_dropped = 0
        self._head_n, self._tail_s, self._always = self._parse(sample)
        self.sample = sample

    @property
    def spans(self) -> list[Span]:
        """Committed spans as ``Span`` objects, in commit order."""
        if self._cache is None or self._cache[0] != self._epoch:
            self._cache = (self._epoch, [Span(*t) for t in self._spans])
        return self._cache[1]

    @staticmethod
    def _parse(spec: str) -> tuple[int, float, bool]:
        head_n, tail_s, always = 0, float("inf"), False
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if part == "always":
                always = True
            elif part.startswith("head:"):
                head_n = max(head_n, int(part[5:]))
            elif part.startswith("tail:"):
                tail_s = min(tail_s, float(part[5:]))
            else:
                raise ValueError(f"unknown trace sampling policy: {part!r}")
        if head_n == 0 and tail_s == float("inf") and not always:
            raise ValueError(f"empty trace sampling spec: {spec!r}")
        return head_n, tail_s, always

    # -- trace lifecycle -------------------------------------------------
    def begin_trace(self) -> int:
        """Open a trace; the returned id doubles as the root span's id so
        children emitted before the root is finalized can parent on it."""
        tid = next(self._ids)
        self.traces_started += 1
        self._staged[tid] = []
        return tid

    def span(
        self,
        name: str,
        start: float,
        end: float,
        trace_id: int,
        parent_id: int | None = None,
        track: tuple[str, str] = ("gateway", "main"),
        **attrs,
    ) -> int:
        """Record a finished interval inside an open trace. Returns the
        new span's id (usable as a parent for further children)."""
        staged = self._staged.get(trace_id)
        if staged is None:
            return 0  # trace already closed or never opened: drop quietly
        sid = next(self._ids)
        staged.append((name, start, end, trace_id, sid, parent_id, track, attrs))
        return sid

    def root_span(
        self,
        name: str,
        start: float,
        end: float,
        trace_id: int,
        track: tuple[str, str] = ("gateway", "main"),
        **attrs,
    ) -> int:
        """Finalize the trace's ROOT span: its span id IS the trace id,
        which is why children emitted earlier could already parent on
        it."""
        staged = self._staged.get(trace_id)
        if staged is None:
            return 0
        staged.append((name, start, end, trace_id, trace_id, None, track, attrs))
        return trace_id

    def instant(
        self,
        name: str,
        at: float,
        trace_id: int,
        parent_id: int | None = None,
        track: tuple[str, str] = ("gateway", "main"),
        **attrs,
    ) -> int:
        return self.span(name, at, at, trace_id, parent_id, track, **attrs)

    def end_trace(self, trace_id: int, latency: float | None = None) -> bool:
        """Close a trace: commit its staged spans to the ring buffer if
        the sampling policy keeps it, drop them otherwise. ``latency``
        feeds the tail policy (None = not a latency-bearing trace; kept
        only by always/head)."""
        staged = self._staged.pop(trace_id, None)
        if staged is None:
            return False
        keep = (
            self._always
            or self.traces_kept < self._head_n
            or (latency is not None and latency >= self._tail_s)
        )
        if keep:
            self.traces_kept += 1
            self._spans.extend(staged)
            self._epoch += 1
        else:
            self.traces_dropped += 1
        return keep

    def abort_trace(self, trace_id: int) -> None:
        self._staged.pop(trace_id, None)

    # -- queries ---------------------------------------------------------
    def trace(self, trace_id: int) -> list[Span]:
        """All committed spans of one trace, ordered by (start, span_id)."""
        out = [s for s in self.spans if s.trace_id == trace_id]
        out.sort(key=lambda s: (s.start, s.span_id))
        return out

    def trace_ids(self) -> list[int]:
        seen: dict[int, None] = {}
        for s in self.spans:
            seen.setdefault(s.trace_id, None)
        return list(seen)

    def resident(self) -> int:
        return len(self._spans) + sum(len(v) for v in self._staged.values())

    def stats(self) -> dict:
        return {
            "started": self.traces_started,
            "kept": self.traces_kept,
            "dropped": self.traces_dropped,
            "spans_resident": self.resident(),
            "capacity": self.capacity,
            "sample": self.sample,
        }


class _NullTracer(Tracer):
    """Shared no-op tracer: every emission site costs one attribute
    check (``tracer.enabled``) and nothing else."""

    def __init__(self):
        super().__init__("always", capacity=1)
        self.enabled = False

    def begin_trace(self) -> int:
        return 0

    def span(self, *a, **k) -> int:
        return 0

    def root_span(self, *a, **k) -> int:
        return 0

    def instant(self, *a, **k) -> int:
        return 0

    def end_trace(self, trace_id: int, latency: float | None = None) -> bool:
        return False

    def abort_trace(self, trace_id: int) -> None:
        pass


NULL_TRACER = _NullTracer()
