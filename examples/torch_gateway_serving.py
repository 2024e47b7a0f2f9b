"""Serve live PUT/GET traffic from the CORE cluster on the PyTorch port.

The twin of examples/gateway_serving.py on ``repro_torch``, with the same
demos, seeds, sizes and printed lines; that file's docstring tells what
each demo shows and how to read a gateway trace. The gateway's decode
and encode windows run as ragged tile-kernel launches on the card (the
GF(256) and XOR tile kernels for GETs, their encode twins for PUTs), the
repairs through the card's codec; ``--device cpu`` runs the kernels'
plain torch versions on the host.

  * default: a Zipf/Poisson trace with two node failures and background
    repair, every GET verified against ground truth;
  * ``--tenants``: two tenants, weighted-fair fabric and SLO admission;
  * ``--scenario``: a correlated rack failure under a load surge plus a
    flapping node, fixed against SLO-paced repair;
  * ``--graybox``: hedged reads against a fail-slow node, then silent
    corruption + fail-slow + crashes (corruption-as-erasure);
  * ``--bakeoff``: RS vs CORE vs LRC on the same objects and fault trace;
  * ``--writes``: write churn, per-PUT sync vs the ragged encode windows,
    with the parity and sealed-stripe audits;
  * ``--shards N``: 1 vs N shard gateways over one store, byte-identical
    payloads, and a shard killed mid-trace;
  * ``--trace out.json``: the default demo with sim-time tracing, written
    as chrome-tracing JSON (https://ui.perfetto.dev).

    PYTHONPATH=src python examples/torch_gateway_serving.py [--device cpu]
    PYTHONPATH=src python examples/torch_gateway_serving.py --tenants
    PYTHONPATH=src python examples/torch_gateway_serving.py --scenario
    PYTHONPATH=src python examples/torch_gateway_serving.py --graybox
    PYTHONPATH=src python examples/torch_gateway_serving.py --bakeoff
    PYTHONPATH=src python examples/torch_gateway_serving.py --writes
    PYTHONPATH=src python examples/torch_gateway_serving.py --shards 4
    PYTHONPATH=src python examples/torch_gateway_serving.py --trace out.json
"""

import argparse

import numpy as np

from repro_torch.core.product_code import CoreCode
from repro_torch.gateway import (
    GatewayConfig,
    ObjectGateway,
    ShardedGateway,
    ShardFailEvent,
    SlowNodeEvent,
    TenantProfile,
    WorkloadConfig,
    generate_requests,
    generate_tenant_requests,
    plan_failures,
    tenant_slo_map,
    tenant_weight_map,
)
from repro_torch.kernels.backend import resolve_device
from repro_torch.scenario import (
    ScenarioConfig,
    correlated_surge_setup,
    flapping_node,
    generate_scenario,
    run_scenario,
)
from repro_torch.storage.netmodel import REPAIR_TENANT, ClusterProfile


def main_default(device: str, trace_out: str | None = None):
    code = CoreCode(9, 6, 3)
    num_objects, q, num_nodes = 30, 1 << 14, 60
    rng = np.random.default_rng(0)

    print(f"CORE ({code.n},{code.k},{code.t}) cluster, {num_nodes} nodes, "
          f"{num_objects} objects of {code.k} x {q // 1024} KiB blocks")

    cfg = GatewayConfig(
        device=device,
        batch_window=0.02,          # 20 ms arrival coalescing
        cache_bytes=24 * q,         # small hot-block cache
        repair_on_failure=True,     # BlockFixer runs in the background
        repair_delay=0.5,           # failure-detection lag
        background_share=0.5,       # repair gets half a link
        tracing=trace_out is not None,  # sim-time spans (see --trace)
    )
    gw = ObjectGateway(code, ClusterProfile.network_critical(), num_nodes, cfg)
    gw.load_objects(rng.integers(0, 256, (num_objects, code.k, q), dtype=np.uint8))

    wl = WorkloadConfig(
        num_objects=num_objects,
        num_requests=1200,
        arrival_rate=1000.0,        # Poisson arrivals
        zipf_s=1.1,                 # popularity skew
        put_fraction=0.05,
        seed=1,
    )
    failures = plan_failures(2, num_nodes, at_time=0.15, spacing=0.25, seed=4)
    print(f"trace: {wl.num_requests} requests @ {wl.arrival_rate:.0f}/s, "
          f"node failures at t=" + ", ".join(f"{f.time:.2f}s" for f in failures))

    report = gw.serve(generate_requests(wl), failures)

    deg = report.degraded_gets
    st = gw.coalescer.stats
    print(f"\nserved {len(report.completed)}/{len(report.records)} requests "
          f"(every GET verified against ground truth)")
    print(f"  throughput      {report.throughput:8.1f} req/s")
    print(f"  latency p50/p99 {report.latency_percentile(50)*1e3:8.2f} / "
          f"{report.latency_percentile(99)*1e3:.2f} ms")
    print(f"  degraded GETs   {len(deg):8d} "
          f"({report.reconstruction_blocks_per_degraded_get:.1f} reconstruction "
          f"blocks each; vertical costs t={code.t}, horizontal k={code.k})")
    print(f"  ragged decode   {st.decode_ops:8d} reconstructions in "
          f"{st.decode_calls} megakernel launches (max batch "
          f"{st.max_batch}, {st.jit_entries} live jit entries, "
          f"{st.launches_per_window:.1f} launches/window, "
          f"{st.padded_byte_ratio:.0%} tile filler)")
    print(f"  block cache     {gw.cache.stats.hits:8d} hits / "
          f"{gw.cache.stats.misses} misses ({gw.cache.stats.hit_rate:.0%})")
    fg_mb = sum(
        v for k, v in gw.sim.class_bytes.items() if k != REPAIR_TENANT
    ) / 1e6
    print(f"  fabric          {fg_mb:8.1f} MB foreground, "
          f"{gw.sim.class_bytes.get(REPAIR_TENANT, 0)/1e6:.1f} MB "
          f"background repair ({len(report.repair_reports)} repair runs)")

    if trace_out is not None:
        from repro_torch.obs import stage_shares, write_chrome_trace

        write_chrome_trace(trace_out, gw.tracer.spans)
        shares = stage_shares(gw.tracer)
        dominant = max(shares["shares"], key=shares["shares"].get)
        print(f"\n  trace           {len(gw.tracer.spans):8d} spans over "
              f"{gw.tracer.traces_kept} traces -> {trace_out}")
        print(f"  critical path   {dominant:>8s} dominates "
              f"({shares['shares'][dominant]:.0%} of total latency; "
              "open the file in https://ui.perfetto.dev)")


def main_tenants(device: str):
    """Two-tenant QoS demo: a premium tenant with a latency SLO shares
    the fabric with a heavily throttled batch tenant."""
    code = CoreCode(9, 6, 3)
    num_objects, q, num_nodes = 30, 1 << 14, 60
    rng = np.random.default_rng(0)
    profiles = [
        TenantProfile("premium", arrival_rate=400.0, weight=1.0, slo_p99=0.1),
        TenantProfile("batch", arrival_rate=400.0, weight=0.25),
    ]
    cfg = GatewayConfig(
        device=device,
        batch_window=0.02,
        tenant_weights=tenant_weight_map(profiles),
        tenant_slo_p99=tenant_slo_map(profiles),
        admission="reject",
    )
    gw = ObjectGateway(code, ClusterProfile.network_critical(), num_nodes, cfg)
    gw.load_objects(rng.integers(0, 256, (num_objects, code.k, q), dtype=np.uint8))

    print(f"CORE ({code.n},{code.k},{code.t}) cluster, two tenants: "
          + ", ".join(f"{p.name} (weight {p.weight}"
                      + (f", SLO p99 {p.slo_p99*1e3:.0f} ms)" if p.slo_p99 else ")")
                      for p in profiles))
    reqs = generate_tenant_requests(profiles, num_objects, 300, seed=1)
    failures = plan_failures(1, num_nodes, at_time=0.1, seed=4)
    report = gw.serve(reqs, failures)

    for p in profiles:
        done = report.tenant_completed(p.name)
        print(f"\n  {p.name}:")
        print(f"    completed       {len(done):6d} / "
              f"{sum(1 for r in reqs if r.tenant == p.name)}"
              f"  (rejected {report.rejections.get(p.name, 0)})")
        print(f"    latency p50/p99 {report.tenant_latency_percentile(p.name, 50)*1e3:8.2f}"
              f" / {report.tenant_latency_percentile(p.name, 99)*1e3:.2f} ms")
        if p.slo_p99:
            print(f"    SLO violations  "
                  f"{report.slo_violation_rate(p.name, p.slo_p99):8.1%} of admitted"
                  f"  (fabric deadline misses "
                  f"{gw.sim.deadline_miss_rate(p.name):.1%})")
        print(f"    worst fabric queueing "
              f"{gw.sim.tenant_wait_max.get(p.name, 0.0)*1e3:.2f} ms")


def main_scenario(device: str):
    """Fault-injection demo: the canonical correlated-failure + surge
    scenario (repro_torch.scenario.correlated_surge_setup — the same setup the
    benchmark gate and regression test validate), replayed with fixed
    full-weight repair and with SLO-paced repair, plus a flapping node
    after the surge. The repair backlog (one rack's worth of every
    group) is far too large to finish inside the surge even at full
    weight — the regime where pacing is a real decision — and p99 is
    measured over requests arriving in the failure + surge window, the
    requests the SLO protects."""
    code = CoreCode(9, 6, 3)
    setup = correlated_surge_setup(code, num_requests=300)
    fail_at, surge_end, slo = setup["fail_at"], setup["surge_end"], setup["slo"]
    trace = flapping_node(setup["trace"], node=0, start=0.7, period=0.1, count=3)

    print(f"CORE ({code.n},{code.k},{code.t}) cluster, {setup['num_nodes']} "
          f"nodes in racks of {code.n - code.k}")
    print(f"trace: rack 2 lost at t={fail_at:.2f}s, node 0 flapping from "
          f"t=0.70s, 1.5x load surge for {surge_end - fail_at:.1f}s; "
          f"SLO p99 {slo * 1e3:.0f} ms")

    for label, pacing in (("fixed full-weight repair", False),
                          ("SLO-paced repair", True)):
        cfg = GatewayConfig(repair_pacing=pacing, device=device,
                            **setup["gateway_kwargs"])
        gw = ObjectGateway(
            code, ClusterProfile.network_critical(), setup["num_nodes"], cfg
        )
        rng = np.random.default_rng(setup["seed"])
        gw.load_objects(rng.integers(
            0, 256,
            (setup["num_objects"], code.k, setup["block_bytes"]),
            dtype=np.uint8,
        ))
        res = run_scenario(gw, trace, setup["workload"])
        rep = res.report
        print(f"\n  {label}:")
        print(f"    p99 in surge      {res.p99_window(fail_at, surge_end)*1e3:8.1f} ms"
              f"   (whole trace p99 {rep.latency_percentile(99)*1e3:.1f} ms)")
        print(f"    MTTR mean/max     {res.mttr_mean:8.3f} / {res.mttr_max:.3f} s"
              f"   ({sum(r.blocks_repaired for r in rep.repair_reports)} blocks repaired)")
        print(f"    degraded GETs     {len(rep.degraded_gets):8d}"
              f"   (negative-cache probes skipped: {gw.cache.stats.negative_hits})")
        if pacing:
            shares = [s for _, s in rep.pacing]
            print(f"    pacing shares     {' '.join(f'{s:.2f}' for s in shares)}")
        audit = res.durability
        print(f"    durability        {audit['blocks_lost']} blocks lost, "
              f"{audit['unreadable_objects']} unreadable, "
              f"{audit['missing_blocks']} still missing")


def main_graybox(device: str):
    """Gray-failure demo: hedged degraded reads racing a fail-slow node,
    then a corruption + fail-slow + crash scenario exercising the
    corruption-as-erasure integrity plane end to end (the same two
    setups the gateway_integrity benchmark rows gate)."""
    code = CoreCode(9, 6, 3)
    q, num_objects = 4096, 30

    # --- experiment 1: fail-slow node, unhedged vs hedged -------------
    # A sparse cluster with uniform popularity keeps the slow-hit
    # fraction structural (~10% of GETs touch the slow node), the regime
    # a 5% speculative byte budget is meant to cover.
    num_nodes = 120
    wl = WorkloadConfig(
        num_objects=num_objects,
        num_requests=300,
        arrival_rate=200.0,
        zipf_s=0.0,
        seed=53,
    )
    reqs = generate_requests(wl)
    print(f"CORE ({code.n},{code.k},{code.t}) cluster, {num_nodes} nodes; "
          f"one node fail-slow at 5% of healthy bandwidth from t=0")
    for label, hedge in (("unhedged", False), ("hedged", True)):
        cfg = GatewayConfig(
            device=device, batch_window=0.005, decode_cost=0.0005, hedge=hedge,
        )
        gw = ObjectGateway(
            code, ClusterProfile.network_critical(), num_nodes, cfg
        )
        rng = np.random.default_rng(53)
        gw.load_objects(
            rng.integers(0, 256, (num_objects, code.k, q), dtype=np.uint8)
        )
        # degrade a node hosting object 0's first data column (placement
        # is seed-deterministic: both runs race the same slow node)
        slow = gw.store.node_of((*gw._objects[0], 0))
        rep = gw.serve(
            reqs, [SlowNodeEvent(time=0.0, node=slow, rate_factor=0.05)]
        )
        m = rep.metrics
        print(f"\n  {label}:")
        print(f"    latency p50/p99 {rep.latency_percentile(50)*1e3:8.2f} / "
              f"{rep.latency_percentile(99)*1e3:.2f} ms")
        if hedge:
            extra = m.counter_total("hedge_bytes") / max(
                sum(gw._fetch_bytes.values()), 1
            )
            print(f"    hedges          {int(m.counter_total('hedge_launched')):8d}"
                  f" launched, {int(m.counter_total('hedge_wins'))} won, "
                  f"{int(m.counter_total('hedge_losses'))} lost, "
                  f"{int(m.counter_total('hedge_budget_denied'))} budget-denied")
            print(f"    extra fabric    {extra:8.1%} speculative bytes "
                  f"(budget {cfg.hedge_budget:.0%})")

    # --- experiment 2: corruption-as-erasure under a gray trace -------
    scfg = ScenarioConfig(
        duration=0.6,
        num_nodes=60,
        nodes_per_rack=3,
        max_concurrent_failures=code.n - code.k,
        crash_rate=4.0,
        mean_downtime=0.08,
        transient_fraction=0.5,
        corruption_rate=10.0,
        corruption_blocks=2,
        slow_rate=5.0,
        slow_factor=0.2,
        mean_slow_time=0.1,
        seed=47,
    )
    trace = generate_scenario(scfg)
    cfg = GatewayConfig(
        device=device,
        batch_window=0.01,
        cache_bytes=8 * q,
        repair_on_failure=True,
        repair_delay=0.03,
        scrub_interval=0.1,
        scrub_blocks_per_run=48,
        decode_cost=0.002,
    )
    gw = ObjectGateway(code, ClusterProfile.network_critical(), 60, cfg)
    rng = np.random.default_rng(47)
    gw.load_objects(
        rng.integers(0, 256, (num_objects, code.k, q), dtype=np.uint8)
    )
    print(f"\ngray trace: {len(trace.fault_events())} fault events over "
          f"{scfg.duration:.1f}s — silent bitflips + fail-slow nodes + "
          f"transient crashes, bounded at n-k={code.n - code.k}")
    res = run_scenario(
        gw,
        trace,
        WorkloadConfig(
            num_objects=num_objects,
            num_requests=300,
            arrival_rate=400.0,
            seed=47,
        ),
    )
    rep = res.report
    m = rep.metrics
    mttd = list(rep.corruption_latency)
    gets_done = sum(1 for r in rep.completed if r.kind == "get")
    wrong = gets_done - int(m.counter_total("verified_gets"))
    print(f"\n  corruption      {int(m.counter_total('blocks_corrupted')):8d}"
          f" blocks silently damaged, "
          f"{int(m.counter_total('corruption_detected'))} detected "
          f"({int(m.counter_total('corruption_detected', source='read'))} by "
          f"fetch verify, "
          f"{int(m.counter_total('corruption_detected', source='scrub'))} by "
          f"scrub)")
    if mttd:
        print(f"    MTTD mean/max {np.mean(mttd)*1e3:8.1f} / "
              f"{np.max(mttd)*1e3:.1f} ms (injection -> checksum detection)")
    print(f"    fail-slow       {int(m.counter_total('slow_events')):8d}"
          f" rate-change events applied to the fabric")
    print(f"    degraded GETs   {len(rep.degraded_gets):8d} of {gets_done} "
          f"(every payload digest-verified; {wrong} wrong bytes served)")
    audit = res.durability
    print(f"    durability      {res.blocks_lost:8d} blocks lost, "
          f"{audit['unreadable_objects']} unreadable, "
          f"{audit['missing_blocks']} still missing after repair")


def main_bakeoff(device: str):
    """Code-family bake-off demo: RS vs CORE vs LRC through the same
    gateway, objects, workload, and Weibull fault trace (the same setup
    the gateway_bakeoff benchmark block gates)."""
    code = CoreCode(9, 6, 3)  # even k, n >= k+2: valid for all 3 families
    q, num_objects, num_nodes = 4096, 30, 60

    scfg = ScenarioConfig(
        duration=0.5,
        num_nodes=num_nodes,
        nodes_per_rack=3,
        max_concurrent_failures=1,  # the paper's single-node-failure regime
        crash_rate=10.0,
        mean_downtime=0.08,
        transient_fraction=0.75,
        interarrival="weibull",     # bursty warehouse-cluster churn
        interarrival_shape=0.7,
        seed=29,
    )
    trace = generate_scenario(scfg)
    wl = WorkloadConfig(
        num_objects=num_objects, num_requests=240, arrival_rate=400.0, seed=29
    )
    print(f"shared shape ({code.n},{code.k},{code.t}), {num_nodes} nodes, "
          f"{len(trace.fault_events())} fault events (Weibull shape "
          f"{scfg.interarrival_shape}, never >1 node down), same workload "
          f"for every family")
    print(f"\n  {'family':>8s} {'fetch/blk':>10s} {'repair ms/blk':>14s} "
          f"{'p99 ms':>8s} {'overhead':>9s} {'tolerance':>10s}")
    fetch_per = {}
    for fam in ("rs", "core", "lrc"):
        cfg = GatewayConfig(
            device=device, code_family=fam, batch_window=0.01,
            repair_on_failure=True, repair_delay=0.02,
        )
        gw = ObjectGateway(
            code, ClusterProfile.network_critical(), num_nodes, cfg
        )
        rng = np.random.default_rng(29)
        gw.load_objects(
            rng.integers(0, 256, (num_objects, code.k, q), dtype=np.uint8)
        )
        res = run_scenario(gw, trace, wl)
        rep = res.report
        fetched = sum(r.blocks_fetched for r in rep.repair_reports)
        repaired = max(sum(r.blocks_repaired for r in rep.repair_reports), 1)
        rtime = sum(r.total_time for r in rep.repair_reports)
        fetch_per[fam] = fetched / repaired
        print(f"  {fam:>8s} {fetch_per[fam]:10.2f} "
              f"{rtime / repaired * 1e3:14.2f} "
              f"{rep.latency_percentile(99) * 1e3:8.2f} "
              f"{gw.family.storage_overhead:9.2f} "
              f"{gw.family.tolerance:10d}")
    print(f"\n  CORE repair traffic = {fetch_per['core'] / fetch_per['rs']:.2f}x "
          f"RS (paper claims ~0.5x); LRC = "
          f"{fetch_per['lrc'] / fetch_per['rs']:.2f}x")


def main_writes(device: str):
    """Write-dataplane demo: the same mixed read/write churn trace
    served through the per-PUT sync baseline and the ragged ENCODE
    megakernel (the setup the gateway_writes benchmark block gates),
    ending with the end-to-end consistency audits."""
    code = CoreCode(9, 6, 3)
    q, num_objects, num_nodes = 4096, 24, 60

    wl = WorkloadConfig(
        num_objects=num_objects,
        num_requests=300,
        arrival_rate=1500.0,
        zipf_s=0.4,
        put_fraction=0.8,           # PUT-heavy: windows hold real batches
        small_put_fraction=0.2,     # a fifth of PUTs are small sealed writes
        small_put_bytes=3000,
        delete_fraction=0.04,
        seed=61,
    )
    reqs = generate_requests(wl)
    n_puts = sum(1 for r in reqs if r.kind == "put")
    n_small = sum(1 for r in reqs if r.kind == "put" and r.nbytes)
    print(f"CORE ({code.n},{code.k},{code.t}) cluster, {num_nodes} nodes; "
          f"{len(reqs)} requests: {n_puts} PUTs ({n_small} small, sealed), "
          f"{sum(1 for r in reqs if r.kind == 'delete')} deletes")
    for mode in ("sync", "ragged"):
        cfg = GatewayConfig(
            device=device,
            batch_window=0.01,
            write_coalesce=mode,
            encode_cost=0.002,      # modeled launch billing (deterministic)
            decode_cost=0.002,
        )
        gw = ObjectGateway(
            code, ClusterProfile.computation_critical(), num_nodes, cfg
        )
        rng = np.random.default_rng(61)
        gw.load_objects(
            rng.integers(0, 256, (num_objects, code.k, q), dtype=np.uint8)
        )
        rep = gw.serve(list(reqs))
        gw.seal_flush(reqs[-1].time + 1.0)
        puts = [r for r in rep.records
                if r.kind == "put" and r.latency is not None]
        lats = sorted(r.latency for r in puts)
        span = (max(r.time + r.latency for r in puts)
                - min(r.time for r in puts))
        st = gw.coalescer.stats
        by_kind = gw.coalescer.jit_entries_by_kind()
        parity = gw.audit_parity()
        sealed = gw.audit_sealed_stripes()
        print(f"\n  write_coalesce={mode}:")
        print(f"    PUT throughput  {len(puts) / max(span, 1e-9):8.1f} put/s "
              f"(p50 {lats[len(lats) // 2] * 1e3:.1f} ms, "
              f"p99 {lats[int(len(lats) * 0.99)] * 1e3:.1f} ms)")
        print(f"    ragged encode   {st.encode_ops:8d} encode ops in "
              f"{st.encode_calls} billed launches over {st.encode_windows} "
              f"windows (live jit: EH {by_kind.get('EH', 0)}, "
              f"EV {by_kind.get('EV', 0)})")
        print(f"    stripes sealed  {sealed['rows_checked']:8d} rows "
              f"({sealed['extents_checked']} small extents; "
              f"{int(rep.metrics.counter_total('stripes_sealed'))} sealed "
              f"mid-trace, the rest at drain)")
        print(f"    parity audit    {parity['blocks_checked']:8d} blocks: "
              f"{parity['stale_blocks']} stale, "
              f"{parity['corrupt_blocks']} corrupt")
        print(f"    sealed audit    {sealed['rows_checked']:8d} rows "
              f"decoded: {sealed['extents_wrong']} wrong extents, "
              f"{sealed['rows_unreadable']} unreadable")


def main_shards(device: str, num_shards: int):
    """Sharded scale-out demo: the same decode-bound trace at 1 shard
    and at N over one shared store (the setup the gateway_shards
    benchmark block gates), then the N-shard run with a whole shard
    killed mid-trace."""
    code = CoreCode(9, 6, 3)
    q, num_objects, num_nodes = 4096, 60, 60
    tenants = [
        TenantProfile("gold", arrival_rate=8000.0, weight=1.0, zipf_s=0.4)
    ]

    def build(shards):
        cfg = GatewayConfig(
            device=device,
            batch_window=0.005,
            decode_cost_per_tile=0.002,  # deterministic per-tile billing
            record_payloads=True,
            tenant_weights=tenant_weight_map(tenants),
            tenant_slo_p99=tenant_slo_map(tenants),
        )
        gw = ShardedGateway(
            code,
            ClusterProfile.computation_critical(),
            num_nodes,
            shards,
            cfg,
            vnodes=256,
        )
        rng = np.random.default_rng(11)
        gw.load_objects(
            rng.integers(0, 256, (num_objects, code.k, q), dtype=np.uint8)
        )
        return gw

    reqs = generate_tenant_requests(tenants, num_objects, 1200, seed=11)
    failures = plan_failures(3, num_nodes, at_time=0.01, spacing=0.0, seed=11)
    print(f"CORE ({code.n},{code.k},{code.t}) cluster, {num_nodes} nodes, "
          f"{len(reqs)} requests, {len(failures)} node failures; "
          f"one shared store under 1 vs {num_shards} shard gateways")

    digests = {}
    rps = {}
    for shards in (1, num_shards):
        gw = build(shards)
        rep = gw.serve(list(reqs), list(failures))
        rps[shards] = rep.throughput
        digests[shards] = {
            (r.time, r.object_id): r.payload_digest
            for r in rep.completed if r.kind == "get"
        }
        print(f"\n  {shards} shard{'s' if shards > 1 else ' '}:")
        print(f"    completed       {len(rep.completed):8d} / {len(reqs)}")
        print(f"    throughput      {rep.throughput:8.1f} req/s")
        print(f"    latency p50/p99 {rep.latency_percentile(50)*1e3:8.2f} / "
              f"{rep.latency_percentile(99)*1e3:.2f} ms")
    match = digests[1] == digests[num_shards]
    print(f"\n  shards speedup    {rps[num_shards] / rps[1]:8.2f}x over "
          f"1 shard on the same store")
    print(f"  routing identity  {len(digests[1]):8d} payload digests "
          f"compared: {'byte-identical' if match else 'MISMATCH'}")

    if num_shards < 2:
        return
    victim = num_shards // 2
    span = max(r.time for r in reqs)
    gw = build(num_shards)
    rep = gw.serve(
        list(reqs),
        list(failures) + [ShardFailEvent(time=span * 0.5, shard=victim)],
    )
    aud = gw.audit_durability()
    print(f"\n  shard {victim} killed at t={span * 0.5:.3f}s:")
    print(f"    survivors       {gw.live_shards()!r} serve the dead "
          f"shard's arcs (minimal movement)")
    print(f"    completed       {len(rep.completed):8d} / {len(reqs)}")
    print(f"    durability      {aud['blocks_lost']:8d} blocks lost, "
          f"{aud['unreadable_objects']} unreadable (store is shared: "
          f"shard death is a serving event)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--tenants", action="store_true",
                    help="two-tenant QoS demo (weights + SLO admission)")
    ap.add_argument("--scenario", action="store_true",
                    help="fault-injection demo (paced vs fixed repair)")
    ap.add_argument("--graybox", action="store_true",
                    help="gray-failure demo (corruption-as-erasure, "
                         "fail-slow injection, hedged degraded reads)")
    ap.add_argument("--bakeoff", action="store_true",
                    help="code-family bake-off demo (RS vs CORE vs LRC "
                         "under the same workload and fault trace)")
    ap.add_argument("--writes", action="store_true",
                    help="write-dataplane demo (ragged ENCODE launches "
                         "vs per-PUT sync baseline + consistency audits)")
    ap.add_argument("--shards", metavar="N", type=int, default=None,
                    help="sharded scale-out demo: N shard gateways over "
                         "one shared store (speedup vs 1 shard, "
                         "byte-identical routing, shard-death failover)")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="run the default demo with sim-time tracing and "
                         "export a Perfetto/chrome-tracing JSON file")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    if args.shards is not None:
        main_shards(device, args.shards)
    elif args.writes:
        main_writes(device)
    elif args.bakeoff:
        main_bakeoff(device)
    elif args.graybox:
        main_graybox(device)
    elif args.scenario:
        main_scenario(device)
    elif args.tenants:
        main_tenants(device)
    else:
        main_default(device, trace_out=args.trace)


if __name__ == "__main__":
    main()
