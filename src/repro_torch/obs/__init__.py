"""Sim-time observability plane: spans, streaming metrics, Perfetto
export and critical-path accounting for the gateway stack; and the
wall-clock host spans of ``obs.host`` (below).

Everything here but ``obs.host`` runs over the SIMULATED clock — spans
measure simulated seconds, not wall time — and is observation-only by
contract: enabling tracing never changes event ordering, simulated
timestamps, or payload bytes (tests/test_obs.py pins traced ≡ untraced fingerprints).

Span taxonomy
=============

Request traces (one per completed GET/PUT; ``trace_id`` doubles as the
root span id so children parent on it before the root is finalized):

  ``request``        root span [arrival, completion]; attrs: object_id,
                     kind, tenant, degraded, bytes, cache_hits, fetch_at
  ``plan``           instant at plan time; attrs: degraded, sources,
                     decodes (instants for admission estimate too)
  ``fetch``          one per fabric-fetched source block
                     [fetch start, block landed]; attrs: key, src, bytes
  ``cache.hit``      instant per cache-served source block
  ``decode``         one per (request, decode op): the launch interval
                     that completed the op [engine start, engine end];
                     attrs: kind, launch_id, fraction, tiles, op (window
                     op index), shared (co-owning requests),
                     op_ready (own sources landed),
                     ready (launch-wide source barrier)
  ``verify``         instant at delivery (ground-truth check, 0 sim cost)
  ``hedge``          one per speculative alternate-path fetch racing a
                     slow direct fetch [hedge launch, last hedge source
                     landed]; attrs: key, kind (V|H), won, attempt
  ``corrupt``        instant at digest-mismatch detection (corruption
                     reclassified as an erasure); attrs: key, source
                     (read | scrub | write | repair)

Infrastructure tracks (emitted into whichever request/repair trace
caused the work):

  ``xfer``           fabric transfer [first byte, last byte] on the
                     SOURCE port's track; attrs: src, dst, bytes,
                     tenant, wait (queueing before the first quantum)
  ``engine.launch``  engine occupancy [start, end] on the engine's track

Repair traces (one per background-repair run):

  ``repair.run``     root span over the run; attrs: groups, healed
  ``pacing``         instant per closed-loop share decision; attrs:
                     share, observed_p99, pressure
  ``repair.group``   one group's fix [detection, fabric makespan];
                     attrs: group, mode, blocks_repaired, recovered
  ``repair.fetch``   one repair step's source gathering; attrs: kind,
                     blocks
  ``repair.decode``  the repair's decode billing on the engine pool
  ``repair.heal``    instant when a block becomes readable again

Scrub traces (one per background scrub tick, on the repair track):

  ``scrub.run``      root span over the tick; attrs: scanned, found
                     (``corrupt`` instants for blocks it catches parent
                     on it)

Track layout (Perfetto: one process per group, one thread per member):

  ``("tenant", <tenant>)``   request roots + per-request stages
  ``("engine", engine<i>)``  decode-engine occupancy
  ``("fabric", port<n>)``    per-send-port transfers
  ``("repair", repair)``     background repair activity

Host spans (``obs.host``: wall clock, not simulated)
=====================================================

``ObjectGateway.serve`` records these while a ``torch.profiler`` runs,
each as a ``repro_torch.<name>`` host range (function scope, so never on
the device's annotation track) on the profiler's clock and as
``host_s`` / ``host_self_s`` / ``host_bytes`` / ``host_calls`` counters
(label ``span``) in the call's ``GatewayReport.metrics``; untraced calls
record nothing. The benchmark's ``portbench/metrics`` readers named in
brackets read them.

  ``gateway.serve``        root: the whole call  [gateway.untraced_pct.*:
                           self over inclusive]
  ``gateway.plan``         ``_flush``: planning and admission of a batch
  ``gateway.fetch``        ``_flush``, per request: ``store.get``, crc32
                           verify and fabric booking of its blocks; bytes
                           fetched; args object_id
                           [gateway.fetch_ms_per_GiB.get]
  ``gateway.decode_check`` ``_flush``: crc32 of the decode outputs
                           against their stored digests; bytes checked
  ``coalescer.stage``      gather of a chunk (bucket) into the staging
                           buffer; bytes staged  [coalescer.host_copy_*]
  ``coalescer.launch``     H2D copy and kernel, the host blocked on the
                           synchronize  [coalescer.device_wait_*]
  ``coalescer.d2h``        ``out.cpu().numpy()``; bytes out
                           [coalescer.device_wait_*]
  ``coalescer.scatter``    copy of ``out`` into the op results; bytes out
                           [coalescer.host_copy_*]
  ``gateway.assemble``     ``_assemble_payload``; bytes of the payload
                           [gateway.assemble_ms_per_GiB.get]
  ``gateway.sha256``       the payload's sha256 (``record_payloads``)
                           [gateway.sha256_ms_per_GiB.get]
  ``repair.verify``        ``_background_repair``'s crc32 of a group's
                           stored blocks; bytes verified
                           [repair.verify_ms_per_GiB]
  ``repair.plan``          ``BlockFixer._fix_family``: a row family's
                           ``repair_plan`` and each global step's
                           ``repair_matrix`` (the host's GF(256)
                           inverse); bytes the plan rebuilds
                           [repair.plan_ms_per_GiB]
  ``repair.fetch``         ``BlockFixer._stage``: the sources of every
                           codec step read with ``store.get`` and gathered
                           into the reused staging buffer (pinned on the
                           card); bytes gathered [repair.fetch_ms_per_GiB]
  ``repair.codec``         ``BlockFixer._measure``: the staged sources'
                           copy to the device, the XOR or GF(256)
                           product, the result's copy back through the
                           second reused buffer into an array of its
                           own; bytes rebuilt
                           [repair.device_wait_ms_per_GiB]
  ``repair.put``           ``store.put_block`` of a rebuilt block (its
                           crc32); bytes written  [repair.put_ms_per_GiB]

Counter ``host_crc32_bytes{impl=fold|zlib}`` (``storage/blockstore.py``,
``host.count``, same rule): the bytes every digest hashed, by the
carry-less-multiply fold of ``storage/crc32.py`` or by zlib
[integrity.crc32_fold_pct].

Sampling: ``Tracer(sample=...)`` takes ``"always"``, ``"head:N"``,
``"tail:SECONDS"`` or comma-combinations (keep if ANY matches), so
tail-latency traces are never dropped while steady-state traffic can be
heavily sampled. Spans land in a bounded ring buffer (``capacity``).

Metrics: ``MetricsRegistry`` (labeled counters / gauges / log-binned
histograms), ``P2Quantile``, ``StreamHist``, and the list-compatible
``BoundedSamples`` / ``BoundedLog`` that replaced ``GatewayReport``'s
unbounded per-request lists — resident memory stays O(1) in trace
length.

Analysis: ``critical_path`` cuts one request's latency into additive
stages (admission / fetch / batch_wait / engine_wait / decode /
deliver); ``stage_shares`` aggregates a run into shares summing to 1.0;
``launch_amortization`` reports how ops shared physical launches.
Export: ``write_chrome_trace`` / ``validate_chrome_trace`` produce and
check Perfetto-loadable JSON (see examples/gateway_serving.py --trace).
"""

from repro_torch.obs.critical_path import (
    PathBreakdown,
    STAGES,
    critical_path,
    launch_amortization,
    stage_shares,
)
from repro_torch.obs.export import (
    to_chrome_trace,
    validate_chrome_trace,
    validate_file,
    write_chrome_trace,
)
from repro_torch.obs import host
from repro_torch.obs.metrics import (
    BoundedLog,
    BoundedSamples,
    Counter,
    Gauge,
    MetricsRegistry,
    P2Quantile,
    StreamHist,
)
from repro_torch.obs.tracer import NULL_TRACER, Span, Tracer

__all__ = [
    "NULL_TRACER",
    "STAGES",
    "BoundedLog",
    "BoundedSamples",
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "P2Quantile",
    "PathBreakdown",
    "Span",
    "StreamHist",
    "Tracer",
    "critical_path",
    "host",
    "launch_amortization",
    "stage_shares",
    "to_chrome_trace",
    "validate_chrome_trace",
    "validate_file",
    "write_chrome_trace",
]
