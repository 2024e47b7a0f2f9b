"""One run of one cell: set-up, the timed window, the comparison with
the reference and the metrics, as ``run.py`` prints them.

Set-up draws the objects on the device from ``--seed`` (one generator
call a gigabyte), copies them to the host once and hands the same
array to the gateway (``load_objects``) and to the reference; crashes
the cell's nodes at simulated time 0; and serves, untimed, each shape
the cell's traffic will use (a degraded GET, two of them, a healthy
GET, a PUT, two PUTs), so that the autotune sweep (its disk cache
pinned under ``build/portbench``) and the coalescer's first launch of
each signature fall into set-up.

The window then drives ``ObjectGateway.serve`` for ``seconds`` of wall
clock by the cell's ``loop`` (``traffic.py``). ``--trace 1`` runs the
same window under ``torch.profiler`` with the harness's spans
(``portbench.window``, ``portbench.serve``, ``portbench.wait``) as user
annotations, and reports the per-layer metrics instead of the
end-to-end ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import pathlib
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from portbench import check, devtrace, spec, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Op:
    kind: str
    object_id: int
    sim_time: float
    due: float  # wall seconds into the window
    issued: float = 0.0
    done: float | None = None  # wall seconds into the window when serve returned
    ok: bool = False
    digest: str | None = None


@dataclass
class Loss:
    node: int
    keys: list
    issued: float
    done: float
    blocks_repaired: int = 0
    bytes_fetched: int = 0


@dataclass
class Run:
    """What the metric readers see (``portbench/metrics/*.py``)."""

    cell: str
    config: dict
    workload: dict
    block_bytes: int
    k: int
    setup_s: float = 0.0
    window_s: float = 0.0
    ops: list[Op] = field(default_factory=list)
    losses: list[Loss] = field(default_factory=list)
    reports: list = field(default_factory=list)
    stats_before: dict = field(default_factory=dict)
    stats_after: dict = field(default_factory=dict)
    decode_out_bytes: int = 0
    digest_s: float = 0.0
    trace: devtrace.Trace | None = None


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    jax, jaxlib, flax or the JAX package (compared whole: ``repro_torch``
    is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def make_objects(seed: int, num: int, k: int, q: int, device: str) -> np.ndarray:
    """(num, k, q) uint8 objects drawn on ``device`` from ``seed``, a
    gigabyte a call, copied once into one host array."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    host = np.empty((num, k, q), dtype=np.uint8)
    per = max(1, (1 << 30) // (k * q))
    for s in range(0, num, per):
        n = min(per, num - s)
        part = torch.randint(0, 256, (n, k, q), dtype=torch.uint8, generator=gen, device=device)
        torch.from_numpy(host[s : s + n]).copy_(part)
        del part
    return host


class Cell:
    """A gateway over one deployment, with the cell's traffic drawn from
    the seed."""

    def __init__(self, name: str, config: dict, workload: dict, seed: int, device: str,
                 cache_dir: pathlib.Path, gateway_overrides: dict | None = None):
        import torch
        from repro_torch.core.product_code import CoreCode
        from repro_torch.gateway import GatewayConfig, ObjectGateway
        from repro_torch.kernels import autotune
        from repro_torch.storage.netmodel import ClusterProfile

        self.name, self.config, self.workload, self.device = name, config, workload, device
        code = config["code"]
        self.k, self.t, self.q = code["k"], code["t"], config["block_bytes"]
        self.rows = self.t + 1
        self.num_objects = config["num_groups"] * self.t
        self.rngs = traffic.streams(seed)
        cache_dir.mkdir(parents=True, exist_ok=True)
        autotune.set_cache_path(cache_dir / "autotune.json")
        settings = dict(config["gateway"])
        settings.update(workload.get("gateway", {}))
        settings.update(gateway_overrides or {})
        settings["device"] = device
        self.objects = make_objects(seed, self.num_objects, self.k, self.q, device)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.gw = ObjectGateway(
            CoreCode(code["n"], code["k"], code["t"]),
            getattr(ClusterProfile, config["cluster_profile"])(),
            config["num_nodes"], GatewayConfig(**settings),
        )
        self.gw.load_objects(self.objects)
        self.sim = 0.0
        self.reports: list = []
        self.lost: set = set()
        self.puts: list[tuple[int, float, bool]] = []
        self.crashed: list[int] = []
        if "crash" in workload:
            self.crash(workload["crash"])
        self.degraded = set(traffic.lost_data_objects(
            {o: self._group_of(o) for o in range(self.num_objects)},
            self.gw.store.placement, set(self.crashed), self.k))
        self.keys = self._keys(workload.get("keys", "all"))
        spread = self.degraded if workload.get("even_ranks") == "lost_data_block" else set()
        self.chooser = traffic.KeyChooser(
            traffic.ranked(self.keys, spread, self.rngs["keys"]), workload.get("zipf_s", 0.99),
            self.rngs["keys"]) if self.keys else None

    # -- set-up --------------------------------------------------------------
    def crash(self, crash: dict) -> None:
        from repro_torch.gateway.workload import FailureEvent

        store = self.gw.store
        self.crashed = traffic.crash_nodes(crash, store.placement, self.rows, self.k,
                                           store.num_nodes)
        self.gw.serve([], [FailureEvent(0.0, n) for n in self.crashed])
        log(f"crashed nodes {self.crashed} at simulated time 0")

    def _group_of(self, oid: int) -> tuple[str, int]:
        return f"g{oid // self.t}", oid % self.t

    def _keys(self, which: str) -> list[int]:
        if not self.workload.get("mix"):
            return []
        if which == "all":
            return list(range(self.num_objects))
        if which == "lost_data_block":
            return sorted(self.degraded)
        raise ValueError(f"unknown key set {which!r}")

    def warm(self) -> None:
        """Serve each shape the traffic uses once, untimed, each in a
        window of its own."""
        mix = {k for k, share in self.workload.get("mix", {}).items() if share > 0}
        degraded = [o for o in self.keys if o in self.degraded]
        healthy = [o for o in self.keys if o not in self.degraded]
        # two objects of different groups, degraded where the key set has them
        pair = (degraded + healthy)[:1]
        pair += [o for o in degraded + healthy
                 if pair and self._group_of(o)[0] != self._group_of(pair[0])[0]][:1]
        batches = []
        if "get" in mix:
            batches += [[("get", o)] for o in (degraded[:1] + healthy[:1])]
            batches.append([("get", o) for o in pair])
        if "put" in mix:
            batches += [[("put", pair[0])], [("put", o) for o in pair]]
        if self.workload["loop"] == "losses":
            self._order = itertools.cycle(traffic.loss_order(self.gw.store.placement))
            self._lose(next(self._order), 0.0, contextlib.nullcontext)
        for batch in batches:
            ops = self.serve_ops([Op(kind, o, self.tick(1.0) + 1e-4 * i, 0.0)
                                  for i, (kind, o) in enumerate(batch)], 0.0)
            bad = [op for op in ops if not op.ok]
            if bad:
                raise RuntimeError(f"warm-up request failed: {bad[0]}")
        self.tick(1.0)

    def tick(self, step: float) -> float:
        self.sim += step
        return self.sim

    # -- the window ----------------------------------------------------------
    def serve_ops(self, ops: list[Op], t0: float, span=contextlib.nullcontext) -> list[Op]:
        """Hand ``ops`` to one ``serve`` call and settle each from its
        record; a call that raises fails all of its ops."""
        from repro_torch.gateway.workload import Request

        issued = time.perf_counter() - t0
        for op in ops:
            op.issued = issued
            if op.kind == "put":
                self.puts.append((op.object_id, op.sim_time, False))
        try:
            with span("portbench.serve"):
                report = self.gw.serve([Request(op.sim_time, op.object_id, op.kind) for op in ops])
        except Exception as exc:  # the program failed these requests
            log(f"serve raised {type(exc).__name__}: {exc}")
            report = None
        done = time.perf_counter() - t0
        recs = {} if report is None else {
            (round(r.time, 9), r.object_id, r.kind): r for r in report.records}
        for op in ops:
            op.done = done
            rec = recs.get((round(op.sim_time, 9), op.object_id, op.kind))
            op.ok = bool(rec is not None and rec.latency is not None and not rec.rejected
                         and (op.kind != "get" or rec.payload_digest is not None))
            op.digest = rec.payload_digest if rec is not None else None
            if op.kind == "put" and op.ok:
                self.puts[self.puts.index((op.object_id, op.sim_time, False))] = (
                    op.object_id, op.sim_time, True)
        if report is not None:
            self.reports.append(report)
        return ops

    def window(self, seconds: float, span) -> tuple[list[Op], list[Loss], float]:
        """Drive the cell's loop for ``seconds``; returns its ops, its
        losses and the window's wall time, to the return of the last
        ``serve`` call (every request due in the window is served)."""
        self.reports = []
        loop = self.workload["loop"]
        t0 = time.perf_counter()
        ops: list[Op] = []
        losses: list[Loss] = []
        with span("portbench.window"):
            if loop == "closed":
                ops = self._closed(seconds, t0, span)
            elif loop == "open":
                ops = self._open(seconds, t0, span)
            elif loop == "losses":
                losses = self._losses(seconds, t0, span)
            else:
                raise ValueError(f"unknown loop {loop!r}")
            window_s = time.perf_counter() - t0
        return ops, losses, window_s

    def _closed(self, seconds: float, t0: float, span) -> list[Op]:
        """One client keeps ``outstanding`` requests of distinct objects in
        each serve call, back to back (so no two GETs of a call share a
        reconstruction); simulated arrivals are Poisson at ``sim_rate``."""
        wl = self.workload
        n, rate = int(wl["outstanding"]), float(wl["sim_rate"])
        ops: list[Op] = []
        while time.perf_counter() - t0 < seconds:
            times = self.sim + np.cumsum(self.rngs["arrivals"].exponential(1.0 / rate, n))
            self.sim = float(times[-1])
            kinds = traffic.kinds_exact(wl["mix"], n, self.rngs["kinds"])
            due = time.perf_counter() - t0
            batch = [Op(kind, oid, float(s), due)
                     for kind, oid, s in zip(kinds, self.chooser.draw_distinct(n), times)]
            ops += self.serve_ops(batch, t0, span)
        return ops

    def _open(self, seconds: float, t0: float, span) -> list[Op]:
        """Requests at ``rate`` a second on the wall clock; at each step
        every request now due goes to one serve call, its simulated
        arrival at its due time."""
        sched = traffic.open_schedule(self.workload, seconds, self.chooser,
                                      self.rngs["kinds"], self.rngs["arrivals"])
        base = self.sim
        ops = [Op(d.kind, d.object_id, base + d.at, d.at) for d in sched]
        self.sim = base + seconds
        i = 0
        while i < len(ops):
            now = time.perf_counter() - t0
            if ops[i].due > now:
                with span("portbench.wait"):
                    time.sleep(ops[i].due - now)
                continue
            j = i
            while j < len(ops) and ops[j].due <= now:
                j += 1
            self.serve_ops(ops[i:j], t0, span)
            i = j
        return ops

    def _losses(self, seconds: float, t0: float, span) -> list[Loss]:
        """Nodes lose their disks one after another (``loss_order``); each
        loss is served with repair on, so the next comes only once
        the previous one is rebuilt."""
        losses: list[Loss] = []
        while time.perf_counter() - t0 < seconds:
            losses.append(self._lose(next(self._order), t0, span))
        return losses

    def _lose(self, node: int, t0: float, span) -> Loss:
        from repro_torch.gateway.workload import CapacityLossEvent

        store = self.gw.store
        keys = [key for key in store.keys_on_node(node) if key in store.blocks]
        self.lost.update(keys)
        issued = time.perf_counter() - t0
        with span("portbench.serve"):
            report = self.gw.serve([], [CapacityLossEvent(self.tick(1.0), node)])
        self.reports.append(report)
        return Loss(node, keys, issued, time.perf_counter() - t0,
                    sum(r.blocks_repaired for r in report.repair_reports),
                    sum(r.bytes_fetched for r in report.repair_reports))

    # -- after the window ----------------------------------------------------
    def readback(self) -> list[Op]:
        """GET, untimed, every object a PUT wrote."""
        written = sorted({oid for oid, _s, _a in self.puts})
        ops = [Op("get", oid, self.tick(1e-3), 0.0) for oid in written]
        for s in range(0, len(ops), 32):
            self.serve_ops(ops[s : s + 32], time.perf_counter())
        return ops

    def stored(self, keys) -> dict:
        """The stored bytes of ``keys`` (None where unavailable)."""
        store = self.gw.store
        return {key: (store.blocks[key] if store.available(key) else None) for key in keys}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str,
             cache_dir: pathlib.Path, started: float, root: pathlib.Path = spec.ROOT,
             gateway_overrides: dict | None = None, config_overrides: dict | None = None,
             fault=None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``started`` is the perf_counter reading at process start. ``fault``,
    for the control and the tests, is called with the gateway after
    set-up and breaks the timed path underneath."""
    import torch

    bench = spec.load(root)
    _entry, config, workload = spec.cell(bench, name, root)
    config = {**config, **(config_overrides or {})}
    seed %= 2**63
    cell = Cell(name, config, workload, seed, device, cache_dir, gateway_overrides)
    cell.warm()
    if fault is not None:
        fault(cell.gw)
    run = Run(name, config, workload, cell.q, cell.k)
    run.stats_before = dataclasses.asdict(cell.gw.coalescer.stats)
    span = contextlib.nullcontext
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        span = record_function
        _count_decode_output(cell.gw, run)
        untime = _time_payload_digest(cell.gw, run)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    if device == "cuda":
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - started
    try:
        run.ops, run.losses, run.window_s = cell.window(seconds, span)
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            untime()
    run.reports = cell.reports
    run.stats_after = dataclasses.asdict(cell.gw.coalescer.stats)
    if prof is not None:
        run.trace = devtrace.from_profiler(prof)
        del prof
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    log(f"window: {run.window_s:.6f} s wall, {len(run.ops)} requests, {len(run.losses)} losses; "
        f"set-up {run.setup_s:.6f} s; device memory peak {peak} bytes")
    _log_window(run)

    # what the program produced, then the program's state freed
    ev = check.Evidence()
    ev.gets = [(op.object_id, op.sim_time, op.digest if op.ok else None)
               for op in run.ops if op.kind == "get"]
    ev.puts = list(cell.puts)
    kinds = {op.kind for op in run.ops}
    if "put" in kinds:
        ev.readback = [(op.object_id, op.sim_time, op.digest if op.ok else None)
                       for op in cell.readback()]
        groups = sorted({cell._group_of(oid)[0] for oid, _s, _a in cell.puts})
        ev.blocks = cell.stored([(g, r, c) for g in groups for r in range(cell.rows)
                                 for c in range(config["code"]["n"])])
    if run.losses:
        ev.lost = cell.stored(sorted(cell.lost))
    objects = cell.objects
    del cell
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check.compare(config, objects, ev, device, kinds, bool(run.losses))
    log(f"reference: {time.perf_counter() - t_ref:.3f} s over {len(ev.gets)} GETs, "
        f"{len(ev.puts)} PUTs, {len(ev.readback)} read-backs, {len(ev.blocks)} group blocks, "
        f"{len(ev.lost)} lost blocks")

    attempted = len(run.ops) + len(run.losses)
    failed = sum(not op.ok for op in run.ops) + sum(
        ev.lost.get(key) is None for loss in run.losses for key in loss.keys)
    metrics = {}
    for m in spec.metrics_for(bench, name, trace):
        value = spec.reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": attempted > 0 and all(v <= lim for v, lim in checks.values()),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": _device(device, peak),
    }
    if run.trace is not None:
        start, end = run.trace.window()
        result["device"]["busy_s"] = run.trace.busy_s(start, end)
        result["device"]["window_s"] = end - start
        result["breakdown"] = devtrace.breakdown(run.trace, start, end)
    result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    return result


def _count_decode_output(gw, run: Run) -> None:
    """A span around the calls into the coalescer: the bytes of decode
    output the window asked of it."""
    execute = gw.coalescer.execute

    def counted(ops, fetch):
        results, units = execute(ops, fetch)
        run.decode_out_bytes += sum(a.nbytes for r in results for a in r.values())
        return results, units

    gw.coalescer.execute = counted


def _time_payload_digest(gw, run: Run):
    """A span from the start of each GET payload's assembly
    (``_assemble_payload``: ``np.stack`` of the fetched and decoded
    blocks) to the end of its sha256 (``tobytes`` and the hash), summed
    into ``run.digest_s``; returns the function that takes it out."""
    module = sys.modules[type(gw).__module__]
    assemble, hashlib = gw._assemble_payload, module.hashlib
    started: list[float] = []

    def timed_assemble(*args, **kwargs):
        started.append(time.perf_counter())
        return assemble(*args, **kwargs)

    class TimedHashlib:
        def __getattr__(self, name):
            return getattr(hashlib, name)

        def sha256(self, *args, **kwargs):
            digest = hashlib.sha256(*args, **kwargs)
            if started:
                run.digest_s += time.perf_counter() - started.pop()
            return digest

    gw._assemble_payload = timed_assemble
    module.hashlib = TimedHashlib()

    def untime():
        module.hashlib = hashlib
        del gw._assemble_payload

    return untime


def _device(device: str, peak: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak)}


def _log_window(run: Run) -> None:
    """Numbers that are no metric: the median, the generator's lateness,
    the gateway's simulated latencies."""
    lat = sorted(op.done - op.due for op in run.ops if op.ok)
    if lat:
        late = sorted(op.issued - op.due for op in run.ops)
        log(f"latency s: p50 {lat[len(lat) // 2]:.6f} max {lat[-1]:.6f} over {len(lat)} served; "
            f"generator lateness s: p50 {late[len(late) // 2]:.6f} max {late[-1]:.6f}")
    sim = [r.latency for rep in run.reports for r in rep.records if r.latency is not None]
    if sim:
        sim.sort()
        log(f"simulated latency s (the gateway's modelled clock): p50 {sim[len(sim) // 2]:.6f} "
            f"p99 {sim[min(len(sim) - 1, int(0.99 * len(sim)))]:.6f}")
    if run.losses:
        log(f"losses: {len(run.losses)}, blocks rebuilt "
            f"{sum(x.blocks_repaired for x in run.losses)}, bytes fetched "
            f"{sum(x.bytes_fetched for x in run.losses)}")
