"""Scenario runner: drive a gateway over a fault trace and summarize.

``run_scenario`` is the one-call harness the tests and the card smoke
share: it synthesizes the surge-aware request stream, replays
the trace's cluster events through ``ObjectGateway.serve`` (the gateway
consumes them mid-run — the planner, negative cache and admission
controller all see availability change between requests), audits
durability at the end, and returns a ``ScenarioResult`` with the
SLO/MTTR metrics the closed-loop repair pacer is judged on.

``deterministic_fingerprint`` hashes the simulation's *discrete*
outcomes (request stream, degradation/rejection flags, fabric bytes,
repair and durability counters) while excluding latency floats and
pacing shares — replaying the same trace + workload seed reproduces it
bit-for-bit, which is the golden-trace guard on the simulated-clock
event ordering. The guarantee requires the discrete outcomes themselves
to be wall-clock-free: bill decode with the modeled
``GatewayConfig.decode_cost`` (as the canonical scenario does), since
under measured billing an admission controller or pacing-dependent
heal gate can flip a borderline degraded/rejected flag between a cold
and a warm run, or between the card and the CPU.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

from repro_torch.gateway.gateway import GatewayReport, ObjectGateway
from repro_torch.gateway.workload import WorkloadConfig
from repro_torch.scenario.trace import (
    ScenarioTrace,
    load_surge,
    rack_failure,
    scenario_requests,
)


@dataclass
class ScenarioResult:
    report: GatewayReport
    durability: dict  # ObjectGateway.audit_durability()
    trace: ScenarioTrace

    @property
    def mttr_mean(self) -> float:
        return self.report.mttr_mean

    @property
    def mttr_max(self) -> float:
        return self.report.mttr_max

    @property
    def blocks_lost(self) -> int:
        return int(self.durability["blocks_lost"])

    def p99_since(self, since: float, tenant: str | None = None) -> float:
        if tenant is None:
            return self.report.latency_percentile(99, since=since)
        return self.report.tenant_latency_percentile(tenant, 99, since=since)

    def p99_window(self, lo: float, hi: float, tenant: str | None = None) -> float:
        """p99 over completed requests ARRIVING in [lo, hi) — the
        under-pressure statistic the pacing gates use: an SLO protects
        the requests that arrive while the fault and surge are live, not
        the calm tail after them. Delegates to the report's single
        quantile definition."""
        if tenant is None:
            return self.report.latency_percentile(99, since=lo, until=hi)
        return self.report.tenant_latency_percentile(tenant, 99, since=lo, until=hi)

    def summary(self) -> dict:
        rep = self.report
        return {
            "requests": len(rep.records),
            "completed": len(rep.completed),
            "rejected": len(rep.rejected),
            "degraded_gets": len(rep.degraded_gets),
            "durability_events": len(self.trace.fault_events()),
            "repairs": len(rep.repair_reports),
            "blocks_repaired": sum(r.blocks_repaired for r in rep.repair_reports),
            "mttr_mean_s": round(self.mttr_mean, 4),
            "mttr_max_s": round(self.mttr_max, 4),
            "blocks_lost": self.blocks_lost,
            "unreadable_objects": int(self.durability["unreadable_objects"]),
            "pacing_updates": len(rep.pacing),
        }


SURGE_FAIL_AT = 0.05
SURGE_END = 0.65


def correlated_surge_setup(code, num_requests: int = 200) -> dict:
    """The canonical paced-vs-fixed repair scenario, defined ONCE and
    shared by the JAX package's benchmark gate, the port's twin test
    (tests/test_torch_scenario.py) and the card smoke (chip_smoke.py
    phase 7) — so all of them validate the same setup.

    Shape: a dense 20-node cluster (racks of n - k, so the correlated
    burst sits exactly at the code's tolerance) loses rack 2 at t=0.05
    while arrivals rise 1.5x until t=0.65. With 40 groups the repair
    backlog is far too large to finish inside the surge even at full
    weight — the regime where pacing is a real decision: the only
    choice is how hard repair leans on the fabric while the surge
    lasts. Decode billing is modeled (``decode_cost``) so replays and
    paced-vs-fixed comparisons are bit-for-bit deterministic.

    Returns a dict with the trace, workload, cluster shape, and the
    GatewayConfig kwargs (everything except ``repair_pacing``, which is
    the variable under test)."""
    num_nodes = 20
    q = 1 << 16
    trace = ScenarioTrace(num_nodes=num_nodes, nodes_per_rack=code.n - code.k)
    trace = rack_failure(trace, SURGE_FAIL_AT, rack=2)
    trace = load_surge(trace, SURGE_FAIL_AT, SURGE_END - SURGE_FAIL_AT, 1.5)
    workload = WorkloadConfig(
        num_objects=120,
        num_requests=num_requests,
        arrival_rate=80.0,
        zipf_s=0.2,  # spread load: no single hot source port
        seed=17,
    )
    slo = 0.12
    gateway_kwargs = dict(
        batch_window=0.01,
        cache_bytes=48 * q,
        repair_on_failure=True,
        repair_delay=0.1,
        background_share=1.0,  # fixed baseline: repair at full weight
        repair_min_share=0.25,
        repair_mttr_target=0.8,
        repair_groups_per_run=2,  # incremental drain: the pacer
        repair_respacing=0.03,  # re-observes between batches
        tenant_slo_p99={"foreground": slo},
        decode_cost=0.002,  # modeled billing: replayable
    )
    return {
        "num_nodes": num_nodes,
        "block_bytes": q,
        "num_objects": workload.num_objects,
        "seed": 17,
        "slo": slo,
        "fail_at": SURGE_FAIL_AT,
        "surge_end": SURGE_END,
        "trace": trace,
        "workload": workload,
        "gateway_kwargs": gateway_kwargs,
    }


def run_scenario(
    gw: ObjectGateway,
    trace: ScenarioTrace,
    wl: WorkloadConfig,
    tenant: str = "foreground",
) -> ScenarioResult:
    reqs = scenario_requests(wl, trace, tenant=tenant)
    report = gw.serve(reqs, trace.cluster_events())
    return ScenarioResult(
        report=report, durability=gw.audit_durability(), trace=trace
    )


def deterministic_fingerprint(result: ScenarioResult) -> str:
    """sha256 over the discrete (wall-clock-free) outcome of a scenario
    run. Two replays of the same trace + workload seed must match."""
    rep = result.report
    payload = {
        "records": [
            [
                round(r.time, 9),
                r.object_id,
                r.kind,
                r.latency is None,
                r.degraded,
                r.rejected,
                r.bytes_read,
                r.reconstruction_blocks,
                r.cache_hits,
                r.tenant,
                r.payload_digest,
            ]
            for r in rep.records
        ],
        "repairs": [
            [r.mode, r.blocks_fetched, r.bytes_fetched, r.blocks_repaired, r.recovered]
            for r in rep.repair_reports
        ],
        "rejections": dict(sorted(rep.rejections.items())),
        "mttr_samples": len(rep.mttr_samples),
        "restored_samples": len(rep.restored_samples),
        "pacing_updates": len(rep.pacing),
        "durability": {
            k: int(v) for k, v in sorted(result.durability.items())
        },
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()
