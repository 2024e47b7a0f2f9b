#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit (``nvidia-smi``), then the build of
   every kernel from ``src/repro_torch/kernels/csrc/*.cu`` and its time;
2. each tile kernel (K1-K4) against its plain torch version on the card,
   ``torch.equal`` over C in {4, 32}, K in {1, 3, 6, 9}, TN in {128, 1024,
   4096} plus zero-padded tiles; then its time at the main-path shape
   (C = 32, TN = 4096, K = 6 for GF and 3 for XOR) beside the plain
   version's and the least time the card could take;
3. the gateway on a small trace, on the card and on the CPU, with
   modeled billing: per-request payload digests, flags and latencies
   must agree;
4. the main path at full width: ``ObjectGateway.serve`` on CORE (9, 6, 3)
   with 64 MiB blocks (HDFS ``dfs.block.size``), 2 CORE groups on 60
   simulated nodes, three failed nodes at time 0, and a 48-request GET/PUT
   trace. Every GET is verified against ground truth, "H", "V", "EH" and
   "EV" ops must all run, every kernel must have been launched, and the
   parity audit must find no stale block. The serve runs under
   ``torch.profiler`` (CUDA activity only), which gives the device's busy
   time beside the serve's wall time.

The last three lines are the kernels' JSON record, the card's name and
power limit again, and the result line ``{"ok": true, "device": {...}}``.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the
# table's only integer rate (int8, dense) for the operations bound.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 1979e12
BLOCK_BYTES = 64 * 1024 * 1024  # Hadoop dfs.block.size = 67108864
MAIN_C, MAIN_TN = 32, 4096

# (C entry, TPU kernel it replaces, GF (else XOR), K at the main-path shape)
KERNELS = (
    ("ragged_gf256_tiles", "src/repro/kernels/ragged_decode.py:144", True, 6),
    ("ragged_xor_tiles", "src/repro/kernels/ragged_decode.py:180", False, 3),
    ("ragged_gf256_encode_tiles", "src/repro/kernels/ragged_encode.py:53", True, 6),
    ("ragged_xor_encode_tiles", "src/repro/kernels/ragged_encode.py:89", False, 3),
)
SOURCE = "src/repro_torch/kernels/csrc/ragged_tiles.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, samples: int = 25, per_sample: int = 20) -> float:
    """Median device time of one call, from CUDA events around
    ``per_sample`` back-to-back calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times)


def device_ms(torch, fn, kernel_name: str, reps: int = 50) -> float | None:
    """Mean device time of one launch of ``kernel_name`` from a
    torch.profiler (CUPTI) trace of ``reps`` calls; None when the trace
    holds no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            total_us += getattr(ev, "device_time_total", 0.0) or 0.0
    return total_us / reps / 1e3 if total_us else None


def tiles(np, torch, rng, c, kk, tn, *, pad: bool):
    """Random (C, K, TN) tiles and (C, K, 8) planes on the card; ``pad``
    zeroes tile tails, trailing K rows and whole null tiles, as the
    coalescer's staging does."""
    from repro_torch.kernels.gf256_matmul import expand_coeff_bitplanes

    data = rng.integers(0, 256, (c, kk, tn), dtype=np.uint8)
    coef = rng.integers(0, 256, (c, kk), dtype=np.uint8)
    if pad:
        data[:, :, tn - tn // 3 :] = 0
        data[:, kk - kk // 2 :, :] = 0
        coef[:, kk - kk // 2 :] = 0
        data[c // 2 :] = 0
        coef[c // 2 :] = 0
    mc = expand_coeff_bitplanes(coef)  # (C, K, 8)
    return torch.from_numpy(mc).cuda(), torch.from_numpy(data).cuda()


def check_kernels(np, torch, seed: int) -> list[dict]:
    from repro_torch.kernels import ops
    from repro_torch.kernels import ragged_decode as rdk

    entry = {
        "ragged_gf256_tiles": ops.gf256_ragged,
        "ragged_xor_tiles": lambda mc, d: ops.xor_ragged(d),
        "ragged_gf256_encode_tiles": ops.gf256_ragged_encode,
        "ragged_xor_encode_tiles": lambda mc, d: ops.xor_ragged_encode(d),
    }
    rng = np.random.default_rng(seed)
    rows = []
    for name, replaces, is_gf, main_k in KERNELS:
        kernel = entry[name]
        plain = rdk.gf_tiles_plain if is_gf else (lambda mc, d: rdk.xor_tiles_plain(d))
        cases = 0
        for c in (4, 32):
            for kk in (1, 3, 6, 9):
                for tn in (128, 1024, 4096):
                    for pad in (False, True):
                        mc, data = tiles(np, torch, rng, c, kk, tn, pad=pad)
                        got = kernel(mc, data)
                        torch.cuda.synchronize()
                        if not torch.equal(got, plain(mc, data)):
                            raise AssertionError(f"{name} != plain at C={c} K={kk} TN={tn} pad={pad}")
                        cases += 1
        mc, data = tiles(np, torch, rng, MAIN_C, main_k, MAIN_TN, pad=False)
        got, want = kernel(mc, data), plain(mc, data)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        if err:
            raise AssertionError(f"{name}: max_abs_err {err} at the main-path shape")
        ms = time_ms(torch, lambda: kernel(mc, data))
        plain_ms = time_ms(torch, lambda: plain(mc, data), samples=9, per_sample=3)
        dev_ms = device_ms(torch, lambda: kernel(mc, data),
                           "gf_tiles_kernel" if is_gf else "xor_tiles_kernel")
        nbytes = data.numel() + MAIN_C * MAIN_TN + (mc.numel() if is_gf else 0)
        # a GF multiply and an XOR per source byte; an XOR per extra slab
        nops = (2 * main_k if is_gf else main_k - 1) * MAIN_C * MAIN_TN
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / INT_OPS_PER_S * 1e3
        row = {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,  # no single PyTorch call computes it
            "device_ms": dev_ms,  # kernel alone, from the profiler trace
        }
        log(
            f"kernel {name}: equal to plain on {cases} cases; C={MAIN_C} K={main_k} "
            f"TN={MAIN_TN}: kernel_ms={ms:.6f} device_ms={dev_ms} plain_ms={plain_ms:.6f} "
            f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) library_ms=null"
        )
        rows.append(row)
    return rows


def small_trace_agrees(np, seed: int) -> None:
    """The small gateway trace of the port's CPU tests, served on the
    card and on the CPU under modeled billing: records must agree."""
    from repro_torch.core.product_code import CoreCode
    from repro_torch.gateway import GatewayConfig, ObjectGateway, WorkloadConfig
    from repro_torch.gateway import generate_requests
    from repro_torch.gateway.workload import FailureEvent
    from repro_torch.storage.netmodel import ClusterProfile

    out = {}
    for device in ("cuda", "cpu"):
        code = CoreCode(9, 6, 3)
        gw = ObjectGateway(
            code, ClusterProfile.network_critical(), 60,
            GatewayConfig(device=device, batch_window=0.01, record_payloads=True,
                          decode_cost_per_tile=1e-5, encode_cost=2e-4),
        )
        rng = np.random.default_rng(seed)
        gw.load_objects(rng.integers(0, 256, (12, code.k, 2048), dtype=np.uint8))
        reqs = generate_requests(WorkloadConfig(
            num_objects=12, num_requests=150, arrival_rate=3000.0,
            put_fraction=0.15, seed=seed,
        ))
        keys = (("g0", 0, 0), ("g0", 1, 0), ("g1", 0, 2))
        fails = [FailureEvent(time=0.005 + 0.01 * i, node=gw.store.node_of(k))
                 for i, k in enumerate(keys)]
        rep = gw.serve(reqs, fails)
        out[device] = [
            (r.time, r.object_id, r.kind, r.degraded, r.payload_digest, r.latency)
            for r in rep.records
        ]
    if out["cuda"] != out["cpu"]:
        raise AssertionError("small trace: card and CPU records differ")
    log(f"small trace: {len(out['cuda'])} records identical on card and CPU")


def serve_full_width(np, seed: int) -> dict[str, int]:
    from repro_torch.core.product_code import CoreCode
    from repro_torch.gateway import GatewayConfig, ObjectGateway, WorkloadConfig
    from repro_torch.gateway import generate_requests
    from repro_torch.gateway.workload import FailureEvent
    from repro_torch.kernels import _build
    from repro_torch.storage.netmodel import ClusterProfile

    code = CoreCode(9, 6, 3)
    gw = ObjectGateway(
        code, ClusterProfile.network_critical(), 60,
        GatewayConfig(device="cuda", autotune=False, batch_window=0.01,
                      record_payloads=True),
    )
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    objects = rng.integers(0, 256, (6, code.k, BLOCK_BYTES), dtype=np.uint8)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gw.load_objects(objects)
    load_s = time.perf_counter() - t0
    keys = (("g0", 0, 0), ("g0", 1, 0), ("g1", 0, 2))
    failures = [FailureEvent(time=0.0, node=gw.store.node_of(k)) for k in keys]
    reqs = generate_requests(WorkloadConfig(
        num_objects=6, num_requests=48, arrival_rate=2000.0,
        put_fraction=0.125, seed=seed,
    ))
    from torch.profiler import ProfilerActivity, profile

    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = gw.serve(reqs, failures)
        serve_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    # device time by activity over the serve (kernels and copies; the
    # serve synchronizes after every chunk, so they do not overlap)
    device = sorted(
        ((ev.device_time_total, ev.count, ev.key) for ev in prof.key_averages()
         if getattr(ev, "device_time_total", 0.0)),
        reverse=True,
    )
    busy_s = sum(us for us, _n, _key in device) / 1e6
    t0 = time.perf_counter()
    audit = gw.audit_parity()
    audit_s = time.perf_counter() - t0

    st = gw.coalescer.stats
    gets = [r for r in report.records if r.kind == "get"]
    verified = report.metrics.counter_total("verified_gets")
    log(
        f"serve: {len(report.records)} requests ({len(gets)} GETs, "
        f"{sum(r.degraded for r in gets)} degraded) on {code} with "
        f"{BLOCK_BYTES}-byte blocks; wall s: data {gen_s:.3f} load {load_s:.3f} "
        f"serve {serve_s:.3f} audit {audit_s:.3f}"
    )
    log(
        f"serve: decode_launches={report.decode_launches} encode_calls={st.encode_calls} "
        f"ops_by_kind={st.ops_by_kind} launches={launches} audit={audit}"
    )
    log(f"serve: device busy {busy_s:.6f} s of {serve_s:.3f} s wall "
        f"(share {busy_s / serve_s:.6f}; torch.profiler, CUDA activity)")
    for us, n, key in device[:8]:
        log(f"serve device: {us / 1e3:.3f} ms in {n} x {key[:90]}")
    bad = [r for r in gets if r.latency is None or r.rejected or r.payload_digest is None]
    if not gets or bad or verified != len(gets):
        raise AssertionError(f"GETs not all served and verified: {len(bad)} bad, "
                             f"{verified} verified of {len(gets)}")
    missing = [k for k in ("H", "V", "EH", "EV") if st.ops_by_kind.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"main path ran no {missing} ops")
    idle = [name for name, n in launches.items() if n <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    if audit["stale_blocks"] != 0:
        raise AssertionError(f"parity audit: {audit}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    path = _build.library()._name
    log(f"build: {pathlib.Path(path).name} in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {_build.build_seconds})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    rows = check_kernels(np, torch, args.seed)
    small_trace_agrees(np, args.seed + 9)
    launches = serve_full_width(np, args.seed)
    for row in rows:
        row["launches"] = launches[row["name"]]
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
