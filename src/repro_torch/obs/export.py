"""Perfetto / chrome-tracing JSON export of a run's spans.

The exporter maps the tracer's ``(group, name)`` tracks onto the chrome
trace model: each track GROUP becomes a process (``pid``) and each track
member a thread (``tid``), named via ``"M"`` metadata events — so a
gateway run opens in https://ui.perfetto.dev (or chrome://tracing) with
one process row per subsystem:

  * ``tenant``  — one thread per tenant: request roots, per-source
    fetches, decode attribution spans;
  * ``engine``  — one thread per simulated decode engine: the launches
    actually occupying it;
  * ``fabric``  — one thread per send port: individual transfers with
    their queueing delay in ``args``;
  * ``repair``  — background repair groups, their fetch phases and
    pacing decisions.

Timestamps are the SIMULATED clock converted to microseconds (the chrome
format's unit) — a span of 3 ms simulated latency renders as 3 ms.
Intervals emit ``ph: "X"`` complete events; zero-duration spans emit
``ph: "i"`` instants. Span attributes ride in ``args`` alongside the
trace/span/parent ids, so Perfetto's flow/selection UI can correlate a
request root with its engine and fabric spans.

``validate_chrome_trace`` is the schema check the CI smoke step runs on
the exported file: structural rules only (required fields, known
phases, non-negative times, metadata naming), not a rendering test.
"""

from __future__ import annotations

import json
from typing import Iterable

from repro_torch.obs.tracer import Span

PHASES = {"X", "i", "M"}


def to_chrome_trace(spans: Iterable[Span]) -> dict:
    """Render spans to a chrome-tracing document (dict, JSON-ready)."""
    pids: dict[str, int] = {}
    tids: dict[tuple[str, str], int] = {}
    events: list[dict] = []
    for s in spans:
        group, member = s.track
        pid = pids.get(group)
        if pid is None:
            pid = pids[group] = len(pids) + 1
            events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": group},
                }
            )
        tkey = (group, member)
        tid = tids.get(tkey)
        if tid is None:
            tid = tids[tkey] = len(tids) + 1
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": member},
                }
            )
        args = {
            "trace_id": s.trace_id,
            "span_id": s.span_id,
            "parent_id": s.parent_id,
        }
        args.update(s.attrs)
        ev = {
            "name": s.name,
            "cat": group,
            "pid": pid,
            "tid": tid,
            "ts": s.start * 1e6,
            "args": args,
        }
        if s.end > s.start:
            ev["ph"] = "X"
            ev["dur"] = (s.end - s.start) * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"  # thread-scoped instant
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Iterable[Span]) -> dict:
    """Export spans to ``path``; returns the document written."""
    doc = to_chrome_trace(spans)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_chrome_trace(doc: dict) -> int:
    """Structural chrome-tracing schema check; raises ValueError on the
    first violation, returns the event count when clean."""
    if not isinstance(doc, dict):
        raise ValueError(f"trace document must be an object, got {type(doc).__name__}")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace document must carry a 'traceEvents' list")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise ValueError(f"{where}: event must be an object")
        for fieldname in ("name", "ph", "pid", "tid"):
            if fieldname not in ev:
                raise ValueError(f"{where}: missing required field {fieldname!r}")
        if not isinstance(ev["name"], str) or not ev["name"]:
            raise ValueError(f"{where}: 'name' must be a non-empty string")
        ph = ev["ph"]
        if ph not in PHASES:
            raise ValueError(f"{where}: unknown phase {ph!r} (want one of {sorted(PHASES)})")
        for fieldname in ("pid", "tid"):
            if not isinstance(ev[fieldname], int):
                raise ValueError(f"{where}: {fieldname!r} must be an int")
        if ph == "M":
            args = ev.get("args")
            if not isinstance(args, dict) or "name" not in args:
                raise ValueError(f"{where}: metadata event needs args.name")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"{where}: 'ts' must be a non-negative number, got {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"{where}: complete event needs non-negative 'dur', got {dur!r}"
                )
    return len(events)


def validate_file(path: str) -> int:
    """Load ``path`` and validate it; returns the event count."""
    with open(path) as f:
        doc = json.load(f)
    return validate_chrome_trace(doc)
