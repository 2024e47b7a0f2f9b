"""Critical-path accounting: decompose a request's latency into additive
stage contributions.

A completed GET's latency is ``done - arrival`` where ``done`` is the
max over its direct-fetch completions and the decode launches it
depends on. Whichever dependency finishes LAST is the critical one, and
the spans the gateway emits carry exactly the intermediate timestamps
needed to cut that terminal chain into consecutive stages:

  arrival -> fetch_start -> sources_ready -> launch_barrier
          -> engine_start -> decode_end -> done

  * ``admission``   — arrival to fetch start (batching-window wait plus
    the serial-mode window barrier);
  * ``fetch``       — fetch start until the critical op's own sources
    landed (fabric serialization + queueing);
  * ``batch_wait``  — waiting for SIBLING ops staged into the same
    physical launch (the coalescing price: a launch's buffer holds every
    one of its ops' tiles);
  * ``engine_wait`` — launch barrier to engine start (decode-engine
    queueing, including tenant-share throttling);
  * ``decode``      — the launch occupying the engine;
  * ``deliver``     — anything after the terminal dependency (0 by
    construction for decode-gated requests; for fetch-gated requests the
    decode stages are all 0 and ``fetch`` runs to the last byte).

The checkpoint sequence is clamped monotonically between arrival and
``done``, so the six stages are non-negative and sum EXACTLY to the
request's latency — which is what makes fleet-level ``stage_shares``
(stage sums normalized by total latency) sum to 1.0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

from repro_torch.obs.tracer import Span, Tracer

STAGES = ("admission", "fetch", "batch_wait", "engine_wait", "decode", "deliver")


@dataclass
class PathBreakdown:
    trace_id: int
    latency: float
    stages: dict  # stage name -> seconds, sums to latency
    gated_by: str  # "decode" | "fetch" | "cache"

    def share(self, stage: str) -> float:
        return self.stages[stage] / self.latency if self.latency > 0 else 0.0


def _clamped_diffs(checkpoints: list[float], t0: float, done: float) -> list[float]:
    """Consecutive differences of ``checkpoints`` clamped monotonically
    into [t0, done] — non-negative, summing exactly to done - t0."""
    out = []
    prev = t0
    for c in checkpoints:
        c = min(max(c, prev), done)
        out.append(c - prev)
        prev = c
    out.append(done - prev)
    return out


def critical_path(spans: Iterable[Span], trace_id: int | None = None) -> PathBreakdown | None:
    """Stage breakdown for one request trace.

    ``spans`` is any span iterable (e.g. ``tracer.trace(tid)`` or
    ``tracer.spans``); when ``trace_id`` is given, spans are filtered to
    it first. Returns None when the trace has no request root."""
    if trace_id is not None:
        spans = [s for s in spans if s.trace_id == trace_id]
    else:
        spans = list(spans)
    root = next((s for s in spans if s.name == "request"), None)
    if root is None:
        return None
    t0, done = root.start, root.end
    latency = done - t0
    stages = dict.fromkeys(STAGES, 0.0)
    decodes = [s for s in spans if s.name == "decode"]
    fetches = [s for s in spans if s.name == "fetch"]
    term_decode = max(decodes, key=lambda s: s.end, default=None)
    term_fetch = max(fetches, key=lambda s: s.end, default=None)
    fetch_at = float(root.attrs.get("fetch_at", t0))
    if term_decode is not None and (
        term_fetch is None or term_decode.end >= term_fetch.end
    ):
        gated = "decode"
        d = term_decode
        diffs = _clamped_diffs(
            [
                fetch_at,
                float(d.attrs.get("op_ready", d.start)),
                float(d.attrs.get("ready", d.start)),
                d.start,
                d.end,
            ],
            t0,
            done,
        )
        for name, dt in zip(
            ("admission", "fetch", "batch_wait", "engine_wait", "decode", "deliver"),
            diffs,
        ):
            stages[name] = dt
    elif term_fetch is not None:
        gated = "fetch"
        adm, fetch, deliver = _clamped_diffs(
            [term_fetch.start, term_fetch.end], t0, done
        )
        stages["admission"] = adm
        stages["fetch"] = fetch
        stages["deliver"] = deliver
    else:
        # cache-only request: no fabric or engine dependency — whatever
        # residual latency exists (cache-readiness gating) is admission
        gated = "cache"
        stages["admission"] = latency
    return PathBreakdown(root.trace_id, latency, stages, gated)


def stage_shares(tracer: Tracer) -> dict:
    """Fleet-level stage attribution over every committed request trace:
    per-stage time sums normalized by total latency. The per-trace
    breakdowns are exactly additive, so the returned shares sum to 1.0
    whenever any latency was observed."""
    sums = dict.fromkeys(STAGES, 0.0)
    total = 0.0
    n = 0
    by_trace: dict[int, list[Span]] = {}
    for s in tracer.spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    for spans in by_trace.values():
        bd = critical_path(spans)
        if bd is None:
            continue
        n += 1
        total += bd.latency
        for k, v in bd.stages.items():
            sums[k] += v
    shares = {
        k: (v / total if total > 0 else 0.0) for k, v in sums.items()
    }
    return {
        "traces": n,
        "total_latency": total,
        "stage_seconds": sums,
        "shares": shares,
    }


def launch_amortization(tracer: Tracer) -> dict:
    """Per-window launch-amortization breakdown from decode spans: how
    many ops shared each physical launch and how its tiles split across
    them (megakernel fractions sum to ~1.0 per launch)."""
    per_launch: dict[int, dict] = {}
    seen: set[tuple] = set()  # a shared op spans once per OWNER trace
    for s in tracer.spans:
        if s.name != "decode":
            continue
        lid = s.attrs.get("launch_id")
        if lid is None or lid < 0:
            continue
        key = (lid, s.attrs.get("op"))
        if key in seen:
            continue
        seen.add(key)
        agg = per_launch.setdefault(lid, {"ops": 0, "fraction": 0.0, "tiles": 0})
        agg["ops"] += 1
        agg["fraction"] += float(s.attrs.get("fraction", 1.0))
        agg["tiles"] += int(s.attrs.get("tiles", 0))
    if not per_launch:
        return {"launches": 0, "ops_per_launch": 0.0, "tiles_per_launch": 0.0}
    n = len(per_launch)
    return {
        "launches": n,
        "ops_per_launch": sum(a["ops"] for a in per_launch.values()) / n,
        "tiles_per_launch": sum(a["tiles"] for a in per_launch.values()) / n,
    }
