#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit (``nvidia-smi``), then the build of
   every kernel from ``src/repro_torch/kernels/csrc/*.cu`` and its time;
2. each tile kernel (K1-K4) against its plain torch version on the card,
   ``torch.equal`` over C in {4, 32}, K in {1, 3, 6, 9}, TN in {128, 1024,
   4096} plus zero-padded tiles, then over the edges of the bodies'
   source-group partitioning (K in {1, 2, 3, 5, 6, 9, 16}, TN in {16,
   128, 1040, 4096, 65536}, and K = 1600); then its times (K = 6 for GF,
   3 for XOR) at the main-path shape (C = 32, TN = 4096), the small chunk
   rung (C = 4) and phase 5's widest tile (TN = 65536): the median and
   least wrapper time, the device time on warm inputs beside the launch
   floor's (a 16-byte ``fill_`` in the same trace) and on cold ones
   (inputs rotated through four times the L2), the least time the card
   could take, and at the main-path shape the plain version's. Then the matrix
   kernels (K5, K6, K7, K7 batched) through ``kernels.ops`` against their
   plain versions over M in {1, 3}, K in {1, 3, 6, 9}, B in {1, 4}, N in
   {128, 4096, 5000, 2^20} (padding included); their times at the 64 MiB
   main-path shapes; a ``block_n`` sweep of K6 and K7 batched at those
   shapes (the autotuner's CUDA candidate sets come from it); and the
   codec path at 64 MiB, driven with the launch counts set to 0: an
   ``rs_encode`` of RS(9, 6), three blocks erased, ``rs_decode`` from the
   six survivors, and a vertical XOR parity of three rows with one row
   repaired from it (K5, K7);
3. the gateway on a small trace, on the card and on the CPU, with
   modeled billing: per-request payload digests, flags and latencies
   must agree, for the ragged dataplane, the bucketed one, and a 2-shard
   ``ShardedGateway``;
4. the ragged path at full width: ``ObjectGateway.serve`` on CORE
   (9, 6, 3) with 64 MiB blocks (HDFS ``dfs.block.size``), 2 CORE groups
   on 60 simulated nodes, three failed nodes at time 0, and a 48-request
   GET/PUT trace, with ``autotune=False``. Every GET is verified against
   ground truth, "H", "V", "EH" and "EV" ops must all run, every tile
   kernel must have been launched, and the parity audit must find no
   stale block. The serve runs under ``torch.profiler`` (CUDA activity
   only), which gives the device's busy time beside the serve's wall time;
5. the bucketed path at full width: the same deployment and trace served
   with ``coalesce="bucketed"`` and the default ``autotune=True`` (its
   disk cache a fresh file under ``build/``), after phase 4's gateway is
   freed. Every GET verified, "H" and "V" ran, K6 and K7 batched launched
   beyond the autotune sweeps' probes, sweeps ran under ``cuda/`` keys,
   and the parity audit is clean;
6. the model path, falcon-mamba-7b (the ssm family): (a) the selective
   scan K8 against its plain version over B in {1, 4, 32}, S in {1, 2, 3,
   7, 8, 9, 16, 128} (one step, and every remainder of the float4 body's
   4-step load batches), D in {200, 1000, 8192} (200 and 1000 leave a
   ragged last block), N in {1, 2, 4, 8, 16, 32}, with and without h0:
   y within rtol = atol = 2e-5 and h_last bit-equal; then its times at
   the prefill chunk (1, 128, 8192, 16) and at the decode step (4, 1,
   8192, 16), warm (the same inputs every launch) and cold (each launch
   the next of 200 MB of input sets), with the plain version's and the
   launch floor's; (b) the reduced config
   in float32 on the card and on the CPU from the same weights: prefill
   logits within rtol = atol = 1e-4 and the
   greedy tokens of a short serve identical; (c) full width and full depth
   (64 layers, bf16 weights drawn from ``--seed`` on the card): a warm-up
   and a profiled 2,048-token prefill (its device breakdown), then the 32,768-token
   prefill of ``SHAPES["prefill_32k"]`` with its batch cut from 32 to 1
   (K8 launched 64 x 256 times), then the reference launcher's default
   serve (8 requests, batch 4, prompt 32, max-new 16, cache-len 128) and a
   short profiled window of the same loop for its device busy share:
   logits finite, every request finished, every token in the vocabulary,
   K8 launched on both paths.
7. the storage paths: (a) the fault-injection scenario engine's
   canonical correlated surge (``correlated_surge_setup``, CORE (9, 6,
   3), 200 requests) with fixed and paced repair, and the gray-failure
   trace of seed 0 (crash + corruption + fail-slow), each on the card
   and on the CPU with autotune off and modeled decode billing:
   ``deterministic_fingerprint`` equal, no block lost, and the degraded
   GETs' tile kernels K1 and K2 launched on the card; (b) the surge at
   the benchmark's full setting, CORE (14, 12, 5) and 600 requests,
   fixed and paced on the card (fingerprints equal to the CPU's): serve
   wall time, simulated p99 since the failure (paced below fixed),
   MTTR, pacing updates, blocks lost (0) and the tile launches of each
   run; (c) the CORE checkpoint layer: a make_state-sized tree's group
   matrices equal on card and CPU, then falcon-mamba-7b's state_dict at
   full width cut to 2 of its 64 layers, saved on the card at (14, 12,
   5) with 64 KiB blocks over 100 nodes, two nodes of group 0 failed,
   restored bit-equal, repaired with every rebuilt block's digest
   verified; save, restore and repair wall times, bytes fetched, and
   one group's encode under the profiler;
8. the training path (TF32 is off for every phase after the build): (a) one
   ``make_train_step`` each of the reduced falcon-mamba, qwen2 and olmoe
   (2 layers each) in float32 on the card against the CPU from the
   same weights (loss within rtol = atol = 1e-4, each gradient leaf
   within 1e-3 of its max |CPU|, the parameters after the update within
   1e-5, no kernel launched), the reduced qwen2 ``Trainer``'s kill ->
   degraded restore (bit-equal) -> repair -> resume on the card, the
   training scan ``_chunk_scan`` against K8's forward at (1, 128, 8192,
   16) (y and h_last within 2e-5), and K8 refusing an operand that
   requires grad; (b) falcon-mamba-7b at full width cut to 2 of its 64
   layers, bf16 weights from ``--seed``: ``Trainer.run`` for 6 steps at
   the launcher's defaults (global batch 8, seq 256) with a CORE
   checkpoint (14, 12, 5) of the whole train state at step 6 over 100
   nodes; each step's wall, loss and grad norm, the median step wall,
   tokens/s and peak memory; step 7 from the in-memory state under the
   profiler (busy share, top device ops); two nodes of group 0 failed,
   ``restore_latest`` bit-equal to the saved state, ``ckpt.repair``
   recovered, and steps 7-8 resumed from the restored state (step-7
   loss within 1e-3 relative of the in-memory one); K8 never launched;
   (c) starcoder2-15b at full width cut to 8 of its 40 layers with
   ``remat_block=2`` (the two-level remat at scale), bf16 weights from
   ``--seed``: ``Trainer.run`` for 6 steps at batch 8 x seq 256 (the
   loop's end-of-run save not made: phase 8(b) measures the save), each
   step's wall, loss and grad norm, the median step wall, tokens/s and
   peak memory, step 7 under the profiler; no kernel launched.

9. the dense and vlm families (TF32 off): (a) each of qwen2-72b,
   mistral-large-123b (at 8 layers with ``remat_block=2``, the
   two-level remat), starcoder2-15b, command-r-35b and pixtral-12b at
   ``reduced()`` in float32 on the card and on the CPU from the same
   weights: ``lm_loss`` within 1e-4 and each gradient leaf within 1e-3
   of its max |CPU|, prefill logits within rtol = atol = 1e-4 and its
   bf16 caches too but for one-ulp neighbours (at most 1e-3 of the
   elements), two float32 decode steps within 1e-4, the
   decode-after-prefill oracle of tests/test_models.py on the card
   (0.05), the greedy tokens of a short serve identical, and a bf16
   prefill and decode with finite logits; (b) starcoder2-15b at full
   width and depth (40 layers, bf16 weights drawn from ``--seed`` on
   the card, 31.9 GB): a warm-up and a profiled 2,048-token prefill,
   the 32,768-token prefill of ``SHAPES["prefill_32k"]`` with its batch
   cut from 32 to 1 (wall, tokens/s, peak memory), then the reference
   launcher's default serve and a short profiled window of it: logits
   finite, every request finished, every token in the vocabulary. No
   hand-written kernel is on this path: phase 9 asserts that it
   launched none.
10. the moe family (TF32 off): (a) olmoe-1b-7b and granite-moe-3b-a800m
   at ``reduced()`` card vs CPU as phase 9(a) holds the dense ids (no
   decode-after-prefill oracle: prefill and decode route with other
   expert capacities); (b) olmoe-1b-7b at full width and depth (16
   layers, 64 experts, top 8, 13.8 GB of bf16 weights drawn from
   ``--seed`` on the card) as phase 9(b) serves starcoder2: a profiled
   2,048-token prefill, the 32,768-token prefill (capacity 5,120 a
   expert), the default serve and a profiled window of it. No kernel
   launched.
11. the hybrid and encdec families (TF32 off): (a) recurrentgemma-9b and
   seamless-m4t-large-v2 at ``reduced()`` card vs CPU as phase 9(a)
   holds the dense ids, over every leaf of the hybrid's nested cache,
   the hybrid's oracle prefilling 76 tokens past its 64-slot window and
   the encdec batch carrying 8 ``src_embed`` frames (the hybrid's card
   prefills launch K8, one launch per rec block); one ``make_train_step``
   each as phase 8(a) runs them (the hybrid at 4 layers, one group and
   a rec tail, its parameters after the update not held against the
   CPU's step: an element whose gradient is near AdamW's 1e-8 moves by
   a fraction of lr where the devices' sums differ in their last bits,
   so the step is held by the gradients and by the card's AdamW on
   them within 1e-5; no kernel launched, so K8 never under grad); K8 on
   the RG-LRU scan at (1, 2048, 4096, 1) from h0 against its plain
   version (y within 2e-5, h_last bit-equal) and ``rglru_scan``'s K8
   route against its associative-scan route (2e-5); K8 at N in {1, 2}
   (its ring body) against its plain version over B in {1, 4}, S in {1,
   15, 16, 17, 127, 128, 129, 2048, 4099} (a stage and the ring, each
   +- 1), D in {200, 1000, 1001, 4096}, with and without h0, and once at (1,
   32768, 4096, 1) (y within 2e-5, h_last bit-equal), then K8's times
   at (1, 2048, 4096, 1) and (1, 32768, 4096, 1); (b) recurrentgemma-9b at full width and
   depth (38 layers = 12 x (rec, rec, attn) + (rec, rec), 17.16 GB of
   bf16 and f32 leaves drawn from ``--seed``): a profiled 2,048-token
   prefill, the 32,768-token prefill at batch 1 (K8 launched once per
   rec block, 26 times), 16 teacher-forced decode steps from its cache
   (the 2,048-slot window ring wraps), the default serve and a profiled
   window of it; (c) seamless-m4t-large-v2 at full width and depth (24
   + 24 layers, 3.27 GB): the same prefills with 1,024 encoder frames
   (the cross-attention scores (1, 16, 32768, 1024) f32, unchunked as in
   the reference), the default serve against ``init_cache``'s zero
   memory, and ``Trainer.run`` for 6 steps at batch 8 x seq 256 (as
   phase 8(c), no save made), step 7 under the profiler. No kernel
   launched on the encdec path.
12. the mesh slice on a one-rank NCCL ``DeviceMesh`` (1, 1) on cuda:0
   (a file rendezvous; the card machine has one H100 and NCCL takes one
   rank per card, so the collectives run in the CPU tests): (a)
   falcon-mamba-7b at full width cut to 2 layers as 8(b) by
   ``Trainer(mesh=...)``, the state as DTensors, 2 steps with the CORE
   save at step 2, restored after two node failures bit-equal and
   resumed to step 3; the losses and the step-3 state held against the
   unsharded ``Trainer``'s steps from the same seed (bit-equal, else
   within 1e-5), one more step profiled; (b) the sequence-sharded
   decode (the flash combine) against the unsharded branch on the card
   over 8 cases, within 1e-5; (c) serving on the mesh: falcon-mamba-7b
   (K8 launched on each rank's shard through ``local_map``) and
   olmoe-1b-7b (the moe dispatch per batch shard) at full width, cut to
   2 layers, f32, the prefill of 1 x 128 tokens (K8 at the kernels
   line's (1, 128, 8192, 16)) and two greedy decodes against the same
   model unsharded (logits within 1e-5 of max |ref|), and olmoe's loss and
   gradients on the mesh (1e-5 relative, 1e-4 of each leaf's max); (d)
   12(a) again with the int8 second moment (``OptConfig(quantize_v=True)``:
   the (q, scale) leaves replicated DTensors, each rank updating the whole
   v from the whole gradient), held against the unsharded quantize_v
   ``Trainer`` (bit-equal, else the floats within 1e-5 and q within 1),
   its step walls and peak memory beside 12(a)'s. Then the process group
   is destroyed.
13. the dry run (``repro_torch.launch.dryrun``), each cell a process of
   its own, all started together: (a) on a fake world of 256 ranks, a
   32 x 8 mesh (32 nodes of 8 NVLink-joined cards), falcon-mamba-7b's
   train_4k (cut to 16 of its 64 layers), prefill_32k and decode_32k,
   olmoe-1b-7b's train_4k and starcoder2-15b's decode_32k, each record
   logged (strategy, per-rank memory against the budget, the three H100
   roofline terms); (b) at a world of 1 (no mesh), the cells phases
   8(b) and 6(c) run, while the card runs the same two steps: the
   argument bytes equal to the real ones, the predicted peak within 20%
   of ``max_memory_allocated``; then the per-rank memory budget the card
   gives (``total_memory`` less what lies outside the allocator and the
   allocator's headroom).
14. the examples: each ``examples/torch_*.py`` through its ``main(argv)``
   on the card, its output logged: quickstart (``verified=True`` four
   times), degraded_read (``ok=True`` three times), repair_scheduling,
   train_tiny_lm at 30 steps (``== OK`` after the degraded restore,
   resumed to step 60), and the gateway example in its eight modes
   (default, ``--tenants``, ``--scenario``, ``--graybox``, ``--bakeoff``,
   ``--writes``, ``--shards 4``, ``--trace`` to a temporary file that
   ``repro_torch.obs.validate_file`` reads): every request served, zero
   wrong bytes, the audits and durability clean; each wall logged, and
   K1-K4 launched on the gateway's windows.

``--tiles-only`` stops after phase 1 and the tile kernels' times (no
check, no result line). ``--scan-only`` builds, prints ptxas's register
and spill report for each K8 body, runs phase 6(a) and the ring body's
sweep of phase 11(a), times K8 at (B, S, 8192, 16) for S in {1, 2, 4,
..., 128} and at (B, S, 4096, 1) for S in {1, 32, 128, 512, 2048, 8192,
32768} (beside each bound), both for B in {1, 4}, times the ring body
at 2 and 4 stages on the same inputs (``scan_plan``'s stage rule), and
stops (no result line).
``--storage-only`` builds, runs phase 7 and stops (no result line).
``--train-only`` builds, runs phase 8 and stops (no result line);
``--dense-only`` the same for phase 9, ``--moe-only`` for phase 10;
``--hybrid-only`` builds and runs phase 11(a) and 11(b) for the hybrid
id, ``--encdec-only`` phase 11(a) and 11(c) for the encdec id;
``--mesh-only`` builds and runs phase 12; ``--dryrun-only`` phase 13;
``--examples-only`` phase 14. The
script imports ``repro_torch`` from the ``src/`` beside it, so a copy of
it placed in another checkout times that checkout's kernels.

The last three lines are the kernels' JSON record (each kernel's
``launches`` from the paths that run it: phases 4, 5, 7 and 14 for K1-K4
(``launches_by_phase``), the codec
path for K5 and K7, phase 5 for K6 and K7 batched (each with phase 14's
count beside it), phase 6(c)'s prefill
and serve, phase 11(b)'s 32k prefill, phase 12(c)'s serves and phase
13(b)'s real prefill for K8, by phase, with K8's
times at the hybrid's shapes under ``hybrid``), the card's name and
power limit again, and the result
line ``{"ok": true, "device": {...}}``.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, the table's
# only integer rate (int8, dense) for the operations bound, and float32
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
BLOCK_BYTES = 64 * 1024 * 1024  # Hadoop dfs.block.size = 67108864
MAIN_C, MAIN_TN = 32, 4096
# (C, TN) at which each tile kernel is timed: the main path, the small
# chunk rung, and the widest tuned tile of phase 5
TILE_SHAPES = ((MAIN_C, MAIN_TN), (4, MAIN_TN), (MAIN_C, 65536))
# the launch floor: the device time of the smallest PyTorch kernel,
# torch.empty(16, dtype=torch.uint8, device="cuda").fill_(0)
FLOOR_KERNEL = "FillFunctor"
# bytes of distinct tiles a cold timing rotates through: four times the
# H100's 50 MB L2, so a launch finds none of its sources there
COLD_BYTES = 200 * 1000 * 1000

# (C entry, TPU kernel it replaces, GF (else XOR), K at the main-path shape)
KERNELS = (
    ("ragged_gf256_tiles", "src/repro/kernels/ragged_decode.py:144", True, 6),
    ("ragged_xor_tiles", "src/repro/kernels/ragged_decode.py:180", False, 3),
    ("ragged_gf256_encode_tiles", "src/repro/kernels/ragged_encode.py:53", True, 6),
    ("ragged_xor_encode_tiles", "src/repro/kernels/ragged_encode.py:89", False, 3),
)
SOURCE = "src/repro_torch/kernels/csrc/ragged_tiles.cu"
# (C entry, TPU kernel it replaces, GF (else XOR), batched, main-path
# shape: (B, M, K, N) for GF and (B, T, N) for XOR, B None when single)
MATRIX_KERNELS = (
    ("gf256_matmul_planes", "src/repro/kernels/gf256_matmul.py:100", True,
     (None, 3, 6, BLOCK_BYTES)),
    ("gf256_matmul_planes_batched", "src/repro/kernels/gf256_matmul.py:142", True,
     (2, 1, 6, BLOCK_BYTES)),
    ("xor_parity", "src/repro/kernels/xor_parity.py:35", False, (None, 3, BLOCK_BYTES)),
    ("xor_parity_batched", "src/repro/kernels/xor_parity.py:56", False,
     (2, 3, BLOCK_BYTES)),
)
MATRIX_SOURCE = "src/repro_torch/kernels/csrc/gf_matmul_xor.cu"
SWEEP_BLOCK_N = (1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072, 262144)
SCAN_SOURCE = "src/repro_torch/kernels/csrc/selective_scan.cu"
SCAN_REPLACES = "src/repro/kernels/selective_scan.py:57"
SCAN_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_selective_scan_kernel.py
PREFILL_CHUNK = (1, 128, 8192, 16)  # (B, S, D, N): one scan_chunk of falcon-mamba-7b
DECODE_STEP = (4, 1, 8192, 16)  # the launcher's decode call at batch 4
# the K8 check's sweep: S = 1 (the float4 body's one-step instance) and
# every remainder of its 4-step load batches, D not a multiple of a
# block's channels, N from the ring body's 1 and 2 to a warp's lanes
SCAN_S = (1, 2, 3, 7, 8, 9, 16, 128)
SCAN_N = (1, 2, 4, 8, 16, 32)
SCAN_D = (200, 1000, 8192)
SCAN_B = (1, 4, 32)
# the ring body's sweep (N in {1, 2}): one step, a stage (16 steps) +- 1,
# 128 steps +- 1, the profiled prefill and a length past it that ends inside
# a stage; D 200 and 1000 leave a ragged last group of 32 columns, 1001
# takes the 4-byte copies (rows not 16-byte aligned)
RING_S = (1, 15, 16, 17, 127, 128, 129, 2048, 4099)
RING_N = (1, 2)
RING_D = (200, 1000, 1001, 4096)
RING_B = (1, 4)
# --scan-only's RG-LRU sweep: K8 at (B, S, 4096, 1)
RGLRU_S = (1, 32, 128, 512, 2048, 8192, 32768)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_samples(torch, fn, samples: int = 25, per_sample: int = 20) -> list[float]:
    """Per-call times (ms) of ``samples`` runs of ``per_sample``
    back-to-back calls, each run timed with CUDA events, after a warm-up
    of at least 5 calls and 50 ms (a host path of microseconds needs
    thousands of calls before its time settles)."""
    calls, t0 = 0, time.perf_counter()
    while calls < 5 or time.perf_counter() - t0 < 0.05:
        fn()
        calls += 1
        if calls % 64 == 0:
            torch.cuda.synchronize()
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
    return times


def time_ms(torch, fn, samples: int = 25, per_sample: int = 20) -> float:
    """Median time of one call, from CUDA events around ``per_sample``
    back-to-back calls."""
    return statistics.median(time_samples(torch, fn, samples, per_sample))


def device_times(torch, fn, names: tuple[str, ...], reps: int = 50) -> list[float | None]:
    """Mean device time (ms) of one launch of each kernel whose name holds
    one of ``names``, from a torch.profiler (CUPTI) trace of ``reps``
    calls of ``fn`` (one launch of each per call), over the launches the
    trace holds; None for a name it holds none of. A trace that lost
    launches is reported, and one that lost half of them or more is taken
    again, up to three times in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        sums = {name: [0.0, 0] for name in names}
        for ev in prof.key_averages():
            for name in names:
                if name in ev.key and getattr(ev, "device_time_total", 0.0):
                    sums[name][0] += ev.device_time_total
                    sums[name][1] += ev.count
        for name, (_us, count) in sums.items():
            if count != reps:
                log(f"device_times({name}): the trace holds {count} of {reps} launches")
        if all(2 * count > reps for _us, count in sums.values()):
            break
    return [us / count / 1e3 if count else None for us, count in sums.values()]


def device_ms(torch, fn, kernel_name: str, reps: int = 50) -> float | None:
    """``device_times`` of one kernel."""
    return device_times(torch, fn, (kernel_name,), reps)[0]


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


def tile_bound_ms(c: int, kk: int, tn: int, is_gf: bool) -> tuple[float, str]:
    """Least time of one tile launch: sources, planes and output moved
    once at the HBM rate, or its integer operations at the int8 rate."""
    nbytes = c * kk * tn + c * tn + (c * kk * 8 if is_gf else 0)
    # a GF multiply and an XOR per source byte; an XOR per extra slab
    nops = (2 * kk if is_gf else kk - 1) * c * tn
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / INT_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def time_tile_shapes(np, torch, rng, name: str, kernel, is_gf: bool, kk: int) -> list[dict]:
    """``kernel`` at each of TILE_SHAPES with K = ``kk``: the median and
    least of its per-call times (CUDA events over back-to-back wrapper
    calls), its device time and the launch floor's from one profiler
    trace on warm inputs (the same tiles every launch, so they stay in
    the L2), its device time on cold inputs (each launch takes the next
    of COLD_BYTES of tiles made on the card), and its bound."""
    kname = "gf_tiles_kernel" if is_gf else "xor_tiles_kernel"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(1 << 31)))
    out = []
    for c, tn in TILE_SHAPES:
        mc, data = tiles(np, torch, rng, c, kk, tn, pad=False)
        samples = time_samples(torch, lambda: kernel(mc, data))
        dev, floor = device_times(
            torch,
            lambda: (kernel(mc, data), torch.empty(16, dtype=torch.uint8, device="cuda").fill_(0)),
            (kname, FLOOR_KERNEL),
        )
        # the planes (C x K x 8 bytes) stay the same: the work does not
        # depend on their values
        pool = torch.randint(0, 256, (-(-COLD_BYTES // data.numel()), *data.shape),
                             dtype=torch.uint8, device="cuda", generator=gen)
        turn = itertools.count()
        cold = device_ms(torch, lambda: kernel(mc, pool[next(turn) % len(pool)]), kname)
        del pool
        bound, by = tile_bound_ms(c, kk, tn, is_gf)
        rec = {"C": c, "K": kk, "TN": tn, "ms": statistics.median(samples),
               "ms_min": min(samples), "device_ms": dev, "floor_ms": floor,
               "device_ms_cold": cold, "bound_ms": bound, "bound_by": by}
        log(f"kernel {name} at C={c} K={kk} TN={tn}: ms median {rec['ms']:.6f} min "
            f"{rec['ms_min']:.6f} device_ms={dev} floor_ms={floor} device_ms_cold={cold} "
            f"bound_ms={bound:.6f} ({by})")
        out.append(rec)
    return out


def tile_entries():
    """C entry -> its port entry, called as (mc, data) for all four."""
    from repro_torch.kernels import ops

    return {
        "ragged_gf256_tiles": ops.gf256_ragged,
        "ragged_xor_tiles": lambda mc, d: ops.xor_ragged(d),
        "ragged_gf256_encode_tiles": ops.gf256_ragged_encode,
        "ragged_xor_encode_tiles": lambda mc, d: ops.xor_ragged_encode(d),
    }


def tile_cases():
    """(C, K, TN, pad) of the equality check: the 48 main cases, then the
    edges of the tile bodies' partitioning (TN from one vector to the
    widest tuned tile and one not a multiple of a block's bytes, K not a
    multiple of any source-group size, and one K above 1536)."""
    for c in (4, 32):
        for kk in (1, 3, 6, 9):
            for tn in (128, 1024, 4096):
                for pad in (False, True):
                    yield c, kk, tn, pad
    for c in (4, 32):
        for kk in (1, 2, 3, 5, 6, 9, 16):
            for tn in (16, 128, 1040, 4096, 65536):
                for pad in (False, True):
                    yield c, kk, tn, pad
    for tn in (16, 1040):
        yield 4, 1600, tn, True


def check_kernels(np, torch, seed: int) -> list[dict]:
    from repro_torch.kernels import ragged_decode as rdk

    entry = tile_entries()
    rng = np.random.default_rng(seed)
    rows = []
    for name, replaces, is_gf, main_k in KERNELS:
        kernel = entry[name]
        plain = rdk.gf_tiles_plain if is_gf else (lambda mc, d: rdk.xor_tiles_plain(d))
        cases = 0
        for c, kk, tn, pad in tile_cases():
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
        plain_ms = time_ms(torch, lambda: plain(mc, data), samples=9, per_sample=3)
        shapes = time_tile_shapes(np, torch, rng, name, kernel, is_gf, main_k)
        main = shapes[0]  # TILE_SHAPES[0] is the main-path shape
        row = {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": err,
            "ms": main["ms"],
            "plain_ms": plain_ms,
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,  # no single PyTorch call computes it
            "device_ms": main["device_ms"],  # kernel alone, from the profiler trace
            "shapes": shapes,
        }
        log(
            f"kernel {name}: equal to plain on {cases} cases; C={MAIN_C} K={main_k} "
            f"TN={MAIN_TN}: kernel_ms={main['ms']:.6f} device_ms={main['device_ms']} "
            f"plain_ms={plain_ms:.6f} bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
            f"library_ms=null"
        )
        rows.append(row)
    return rows


def check_matrix_kernels(np, torch, seed: int) -> list[dict]:
    """K5, K6, K7 and K7 batched through ``kernels.ops`` (padding to a
    block_n multiple included) against their plain versions; then their
    times at the 64 MiB main-path shapes and a block_n sweep."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.gf256_matmul import (
        gf256_matmul_planes, gf256_matmul_planes_batched, gf_matmul_plain,
    )
    from repro_torch.kernels.xor_parity import xor_parity, xor_parity_batched, xor_rows_plain

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)

    cases = 0
    for b in (1, 4):
        for m in (1, 3):
            for kk in (1, 3, 6, 9):
                for n in (128, 4096, 5000, 1 << 20):
                    data = rand(b, kk, n)
                    coefs = rng.integers(0, 256, (b, m, kk), dtype=np.uint8)
                    want = gf_matmul_plain(ops._planes(coefs, data.device), data)
                    want_x = xor_rows_plain(data)
                    got = {
                        "gf256_matmul_planes_batched": (
                            ops.gf256_matmul_batched(coefs, data), want),
                        "gf256_matmul_planes": (ops.gf256_matmul(coefs[0], data[0]), want[0]),
                        "xor_parity_batched": (ops.xor_parity_batched(data), want_x),
                        "xor_parity": (ops.xor_parity(data[0]), want_x[0]),
                    }
                    torch.cuda.synchronize()
                    for name, (g, w) in got.items():
                        if not torch.equal(g, w):
                            raise AssertionError(f"{name} != plain at B={b} M={m} K={kk} N={n}")
                    cases += 1
    log(f"matrix kernels: K5, K6, K7, K7 batched equal to plain on {cases} cases each")

    rows = []
    for name, replaces, is_gf, shape in MATRIX_KERNELS:
        batched = shape[0] is not None
        lead = (shape[0],) if batched else ()
        if is_gf:
            _b, m, kk, n = shape
            data = rand(*lead, kk, n)
            coefs = rng.integers(0, 256, (*lead, m, kk), dtype=np.uint8)
            mc = ops._planes(coefs, data.device)
            body = gf256_matmul_planes_batched if batched else gf256_matmul_planes
            kernel = lambda bn=None, body=body, mc=mc, data=data: body(  # noqa: E731
                mc, data, **({} if bn is None else {"block_n": bn}))
            plain = lambda mc=mc, data=data: gf_matmul_plain(mc, data)  # noqa: E731
            out_bytes = m * n
            # a GF multiply and an XOR per source byte and target
            nops = 2 * m * kk * n
            kname = "gf_matmul_kernel"
        else:
            _b, t, n = shape
            data = rand(*lead, t, n)
            body = xor_parity_batched if batched else xor_parity
            kernel = lambda bn=None, body=body, data=data: body(  # noqa: E731
                data, **({} if bn is None else {"block_n": bn}))
            plain = lambda data=data: xor_rows_plain(data)  # noqa: E731
            out_bytes = n
            nops = (t - 1) * n  # an XOR per extra row
            kname = "xor_rows_kernel"
        scale = shape[0] or 1
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        del got, want
        if err:
            raise AssertionError(f"{name}: max_abs_err {err} at the main-path shape")
        ms = time_ms(torch, kernel, samples=15, per_sample=10)
        plain_ms = time_ms(torch, plain, samples=5, per_sample=2)
        dev_ms = device_ms(torch, kernel, kname, reps=20)
        nbytes = data.numel() + scale * out_bytes
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = scale * nops / INT_OPS_PER_S * 1e3
        sweep = {bn: time_ms(torch, lambda bn=bn: kernel(bn), samples=7, per_sample=5)
                 for bn in SWEEP_BLOCK_N}
        row = {
            "name": name,
            "route": "cuda",
            "source": MATRIX_SOURCE,
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
            f"kernel {name}: shape {shape} at the default block_n: kernel_ms={ms:.6f} "
            f"device_ms={dev_ms} plain_ms={plain_ms:.6f} bound_ms={row['bound_ms']:.6f} "
            f"({row['bound_by']}) library_ms=null"
        )
        log(f"kernel {name}: block_n sweep ms {json.dumps(sweep)}")
        rows.append(row)
        del data
    torch.cuda.empty_cache()
    return rows


def codec_path(np, torch, seed: int) -> dict[str, int]:
    """The single-op entries at 64 MiB, driven with the launch counts set
    to 0: RS(9, 6) encode, three blocks erased, decode from the six
    survivors (K5); a vertical XOR parity of three rows and one row
    repaired from it (K7). Returns the launch counts of that run."""
    from repro_torch.coding import rs
    from repro_torch.kernels import _build, ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    data = torch.randint(0, 256, (6, BLOCK_BYTES), dtype=torch.uint8, device="cuda",
                         generator=gen)
    rows = torch.randint(0, 256, (3, BLOCK_BYTES), dtype=torch.uint8, device="cuda",
                         generator=gen)
    code = rs.make_rs(9, 6)
    _build.reset_launches()
    t0 = time.perf_counter()
    stripe = torch.cat([data, ops.rs_encode(rs.parity_matrix(9, 6), data)])
    avail = np.asarray([c for c in range(9) if c not in (0, 4, 7)])
    row_ids, inverse = code.decode_matrix(avail)
    decoded = ops.rs_decode(inverse, stripe[torch.from_numpy(row_ids).cuda()])
    vparity = ops.xor_parity(rows)
    repaired = ops.xor_parity(torch.stack([rows[0], rows[2], vparity]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    if not torch.equal(decoded, data):
        raise AssertionError("codec path: rs_decode did not restore the erased stripe")
    if not torch.equal(repaired, rows[1]):
        raise AssertionError("codec path: the XOR repair did not restore the row")
    used = {k: n for k, n in launches.items() if n}
    if used != {"gf256_matmul_planes": 2, "xor_parity": 2}:
        raise AssertionError(f"codec path launched {used}")
    log(f"codec path: RS(9,6) encode + decode of 3 erased {BLOCK_BYTES}-byte blocks and a "
        f"3-row XOR parity + repair restored every byte in {wall:.6f} s wall; launches {used}")
    del data, rows, stripe, decoded, vparity, repaired
    torch.cuda.empty_cache()
    return launches


def small_trace_agrees(np, seed: int) -> None:
    """The small gateway trace of the port's CPU tests, served on the
    card and on the CPU under modeled billing with autotune off: records
    must agree, for the ragged dataplane, the bucketed one and a 2-shard
    ShardedGateway."""
    from repro_torch.core.product_code import CoreCode
    from repro_torch.gateway import GatewayConfig, ObjectGateway, ShardedGateway
    from repro_torch.gateway import WorkloadConfig, generate_requests
    from repro_torch.gateway.workload import FailureEvent
    from repro_torch.storage.netmodel import ClusterProfile

    variants = {
        "ragged": ({"decode_cost_per_tile": 1e-5}, 1),
        "bucketed": ({"coalesce": "bucketed", "decode_cost": 1e-4}, 1),
        "sharded-2": ({"decode_cost_per_tile": 1e-5}, 2),
    }
    for label, (billing, shards) in variants.items():
        out = {}
        for device in ("cuda", "cpu"):
            code = CoreCode(9, 6, 3)
            cfg = GatewayConfig(device=device, autotune=False, batch_window=0.01,
                                record_payloads=True, encode_cost=2e-4, **billing)
            if shards == 1:
                gw = ObjectGateway(code, ClusterProfile.network_critical(), 60, cfg)
            else:
                gw = ShardedGateway(code, ClusterProfile.network_critical(), 60, shards, cfg)
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
            raise AssertionError(f"small trace ({label}): card and CPU records differ")
        log(f"small trace ({label}): {len(out['cuda'])} records identical on card and CPU")


def serve_full_width(np, seed: int, *, coalesce: str, autotune: bool) -> dict:
    """Serve the 64 MiB deployment once under torch.profiler with the
    launch counts set to 0 just before; every GET must verify and the
    parity audit must be clean. Returns the counts and the coalescer's
    record (the gateway itself is freed on return)."""
    from repro_torch.core.product_code import CoreCode
    from repro_torch.gateway import GatewayConfig, ObjectGateway, WorkloadConfig
    from repro_torch.gateway import generate_requests
    from repro_torch.gateway.coalescer import BUCKETED
    from repro_torch.gateway.workload import FailureEvent
    from repro_torch.kernels import _build
    from repro_torch.storage.netmodel import ClusterProfile

    code = CoreCode(9, 6, 3)
    gw = ObjectGateway(
        code, ClusterProfile.network_critical(), 60,
        GatewayConfig(device="cuda", coalesce=coalesce, autotune=autotune,
                      batch_window=0.01, record_payloads=True),
    )
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    objects = rng.integers(0, 256, (6, code.k, BLOCK_BYTES), dtype=np.uint8)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gw.load_objects(objects)
    load_s = time.perf_counter() - t0
    del objects
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
    # serve synchronizes after every launch, so they do not overlap)
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
    tag = f"serve[{coalesce}, autotune={autotune}]"
    gets = [r for r in report.records if r.kind == "get"]
    verified = report.metrics.counter_total("verified_gets")
    log(
        f"{tag}: {len(report.records)} requests ({len(gets)} GETs, "
        f"{sum(r.degraded for r in gets)} degraded) on {code} with "
        f"{BLOCK_BYTES}-byte blocks; wall s: data {gen_s:.3f} load {load_s:.3f} "
        f"serve {serve_s:.3f} audit {audit_s:.3f}"
    )
    buckets = sorted(
        (sig[1], sig[2], sig[3]) for sig in gw.coalescer._warm if sig[0] == BUCKETED
    )
    log(
        f"{tag}: decode_launches={report.decode_launches} encode_calls={st.encode_calls} "
        f"ops_by_kind={st.ops_by_kind} batch_hist={st.batch_hist} "
        f"padded_ops={st.padded_ops} launches={launches} audit={audit}"
    )
    if buckets:
        log(f"{tag}: bucket shapes launched ((kind, M, K), B_pad, N): {buckets}")
    log(f"{tag}: device busy {busy_s:.6f} s of {serve_s:.3f} s wall "
        f"(share {busy_s / serve_s:.6f}; torch.profiler, CUDA activity)")
    for us, n, key in device[:8]:
        log(f"{tag} device: {us / 1e3:.3f} ms in {n} x {key[:90]}")
    bad = [r for r in gets if r.latency is None or r.rejected or r.payload_digest is None]
    if not gets or bad or verified != len(gets):
        raise AssertionError(f"{tag}: GETs not all served and verified: {len(bad)} bad, "
                             f"{verified} verified of {len(gets)}")
    if audit["stale_blocks"] != 0:
        raise AssertionError(f"{tag}: parity audit: {audit}")
    return {"launches": launches, "ops_by_kind": dict(st.ops_by_kind),
            "decode_launches": report.decode_launches}


def serve_ragged(np, seed: int) -> dict[str, int]:
    """Phase 4: the ragged path, autotune off, every tile kernel."""
    run = serve_full_width(np, seed, coalesce="ragged", autotune=False)
    missing = [k for k in ("H", "V", "EH", "EV") if run["ops_by_kind"].get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"ragged path ran no {missing} ops")
    tiles = [name for name, _r, _gf, _k in KERNELS]
    idle = [name for name in tiles if run["launches"][name] <= 0]
    if idle:
        raise AssertionError(f"tile kernels never launched on the ragged path: {idle}")
    return run["launches"]


def serve_bucketed(np, seed: int) -> dict[str, int]:
    """Phase 5: the bucketed path with the default autotune=True, its
    disk cache a fresh file inside the checkout."""
    from repro_torch.kernels import autotune

    cache = ROOT / "build" / "chip_smoke_autotune.json"
    cache.unlink(missing_ok=True)
    autotune.set_cache_path(cache)
    run = serve_full_width(np, seed, coalesce="bucketed", autotune=True)
    launches = run["launches"]
    report, stats, sweeps = autotune.report(), autotune.cache_stats(), autotune.sweep_times()
    log(f"autotune: report {json.dumps(report)}")
    disk_keys = sorted(json.loads(cache.read_text())["entries"])
    log(f"autotune: cache_stats {stats}; disk keys {disk_keys}")
    for key, times in sweeps.items():
        log(f"autotune: sweep {key} s per probe {json.dumps(times)}")
    missing = [k for k in ("H", "V") if run["ops_by_kind"].get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"bucketed path ran no {missing} ops")
    if stats["sweeps"] <= 0 or not report or not all(k.startswith("cuda/") for k in report):
        raise AssertionError(f"autotune: no sweep on the card ({stats}, {sorted(report)})")
    # each sweep launches (1 + repeats) probes per candidate; the serve's
    # own stacked launches come on top
    probes = {
        "gf256_matmul_planes_batched": len(autotune.GF_BLOCK_CANDIDATES["cuda"]),
        "xor_parity_batched": len(autotune.XOR_BLOCK_CANDIDATES["cuda"]),
    }
    for name, n_cands in probes.items():
        swept = (1 + autotune._PROBE_REPEATS) * n_cands
        if launches[name] <= swept:
            raise AssertionError(f"{name}: {launches[name]} launches, all autotune probes "
                                 f"({swept}); the serve's decodes never ran it")
    for name in ("ragged_gf256_encode_tiles", "ragged_xor_encode_tiles"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the bucketed path's PUTs")
    return launches


def scan_inputs(torch, b, s, d, n, seed):
    """The JAX test's distributions on the card: da in U(0.6, 0.999); dbu,
    cm and h0 standard normal."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    f32 = dict(dtype=torch.float32, device="cuda", generator=gen)
    da = torch.rand((b, s, d, n), **f32).mul_(0.399).add_(0.6)
    return (da, torch.randn((b, s, d, n), **f32), torch.randn((b, s, n), **f32),
            torch.randn((b, d, n), **f32))


def scan_bytes(b, s, d, n) -> int:
    """Bytes K8 must move: da, dbu, cm and h0 read once; y and h_last
    written once."""
    return 4 * (2 * b * s * d * n + b * s * n + b * d * n + b * s * d + b * d * n)


def scan_times(torch, shape, seed: int, plain_ms: float | None = None) -> dict:
    """K8 with h0 and h_last at ``shape``: the median and least wrapper
    time (CUDA events), the device time warm (the same inputs every
    launch) beside the launch floor's (a 16-byte ``fill_`` in the same
    trace) and cold (each launch the next of COLD_BYTES of input sets),
    the plain version's time (timed here unless ``plain_ms`` is given)
    and the bound."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

    b, s, d, n = shape
    da, dbu, cm, h0 = scan_inputs(torch, b, s, d, n, seed)
    kernel = lambda: selective_scan(da, dbu, cm, h0=h0, return_state=True)  # noqa: E731
    samples = time_samples(torch, kernel)
    dev, floor = device_times(
        torch,
        lambda: (kernel(), torch.empty(16, dtype=torch.uint8, device="cuda").fill_(0)),
        ("selective_scan_kernel", FLOOR_KERNEL),
    )
    if plain_ms is None:
        plain_ms = time_ms(torch, lambda: selective_scan_plain(da, dbu, cm, h0), samples=5,
                           per_sample=2)
    del da, dbu, cm, h0
    nbytes = scan_bytes(b, s, d, n)
    sets = -(-COLD_BYTES // (nbytes - 4 * (b * s * d + b * d * n)))  # input bytes per set
    pool = [scan_inputs(torch, b, s, d, n, seed + 1 + i) for i in range(sets)]
    turn = itertools.count()

    def cold_call():
        da, dbu, cm, h0 = pool[next(turn) % sets]
        return selective_scan(da, dbu, cm, h0=h0, return_state=True)

    cold = device_ms(torch, cold_call, "selective_scan_kernel")
    del pool
    torch.cuda.empty_cache()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * b * s * d * n / F32_OPS_PER_S * 1e3  # h and y: a multiply and an add each
    rec = {"shape": list(shape), "ms": statistics.median(samples), "ms_min": min(samples),
           "device_ms": dev, "floor_ms": floor, "device_ms_cold": cold, "cold_sets": sets,
           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes}
    log(f"kernel selective_scan at {shape} with h0: {json.dumps(rec)}")
    return rec


def scan_sweep_agrees(torch, seed: int, bs, ss, ds, ns) -> dict:
    """K8 against its plain version at every (B, S, D, N) of the product
    of ``bs``, ``ss``, ``ds`` and ``ns``, with and without h0: y within
    SCAN_TOL, h_last bit-equal (both update h with a multiply, then an
    add). Returns the case count and y's largest error."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

    cases, err = 0, 0.0
    for b, s, d, n in itertools.product(bs, ss, ds, ns):
        da, dbu, cm, h0 = scan_inputs(torch, b, s, d, n, seed + cases)
        for start in (None, h0):
            y, h = selective_scan(da, dbu, cm, h0=start, return_state=True)
            want_y, want_h = selective_scan_plain(da, dbu, cm, start)
            torch.cuda.synchronize()
            where = f"B={b} S={s} D={d} N={n} h0={start is not None}"
            torch.testing.assert_close(y, want_y, **SCAN_TOL, msg=lambda m: f"y at {where}: {m}")
            if not torch.equal(h, want_h):
                raise AssertionError(f"h_last not bit-equal to plain at {where}: max_abs_err "
                                     f"{float((h - want_h).abs().max())}")
            err = max(err, float((y - want_y).abs().max()))
            cases += 1
        del da, dbu, cm, h0, y, h, want_y, want_h
    torch.cuda.empty_cache()
    log(f"kernel selective_scan: y within rtol=atol=2e-5 and h_last bit-equal to plain on "
        f"{cases} cases (B {bs}, S {ss}, D {ds}, N {ns}, with and without h0; y max_abs_err "
        f"{err})")
    return {"cases": cases, "max_abs_err": err}


def scan_held_once(torch, shape, seed: int) -> tuple[float, float]:
    """K8 at ``shape`` from h0 against its plain version, once: y within
    SCAN_TOL, h_last bit-equal. Returns y's largest error and the plain
    version's time (ms) for that one call, by CUDA events."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

    da, dbu, cm, h0 = scan_inputs(torch, *shape, seed)
    y, h = selective_scan(da, dbu, cm, h0=h0, return_state=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want_y, want_h = selective_scan_plain(da, dbu, cm, h0)
    end.record()
    end.synchronize()
    torch.testing.assert_close(y, want_y, **SCAN_TOL, msg=lambda m: f"y at {shape}: {m}")
    if not torch.equal(h, want_h):
        raise AssertionError(f"K8 at {shape}: h_last not bit-equal to plain (max_abs_err "
                             f"{float((h - want_h).abs().max())})")
    err = float((y - want_y).abs().max())
    del da, dbu, cm, h0, y, h, want_y, want_h
    torch.cuda.empty_cache()
    return err, start.elapsed_time(end)


def check_scan_kernel(torch, seed: int) -> dict:
    """Phase 6(a): K8 against its plain version over the sweep
    (``scan_sweep_agrees``), then its times at the prefill chunk and at
    the decode step."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

    scan_sweep_agrees(torch, seed, SCAN_B, SCAN_S, SCAN_D, SCAN_N)
    b, s, d, n = PREFILL_CHUNK
    da, dbu, cm, h0 = scan_inputs(torch, b, s, d, n, seed)
    y, h = selective_scan(da, dbu, cm, h0=h0, return_state=True)
    want_y, want_h = selective_scan_plain(da, dbu, cm, h0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want_y, **SCAN_TOL)
    torch.testing.assert_close(h, want_h, **SCAN_TOL)
    main_err = max(float((y - want_y).abs().max()), float((h - want_h).abs().max()))
    del da, dbu, cm, h0, y, h, want_y, want_h
    main = scan_times(torch, PREFILL_CHUNK, seed)
    row = {
        "name": "selective_scan",
        "route": "cuda",
        "source": SCAN_SOURCE,
        "replaces": SCAN_REPLACES,
        "launches": 0,
        "max_abs_err": main_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        # no single PyTorch call computes a linear recurrence with an
        # output contraction
        "library_ms": None,
        "device_ms": main["device_ms"],
        "device_ms_cold": main["device_ms_cold"],
        # the decode step's shape: one token for each of 4 slots, from h0
        "decode": scan_times(torch, DECODE_STEP, seed),
    }
    log(f"kernel selective_scan: {PREFILL_CHUNK} with h0: kernel_ms={row['ms']:.6f} "
        f"device_ms={row['device_ms']} plain_ms={row['plain_ms']:.6f} "
        f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) library_ms=null")
    return row


def scan_s_sweep(torch, seed: int, d: int, n: int, ss) -> dict:
    """K8's warm device time (ms) at (B, S, d, n) with h0 for B in {1, 4}
    and S in ``ss``, each beside its byte bound: run from another
    checkout, how its body compares over S."""
    from repro_torch.kernels.selective_scan import selective_scan

    out = {}
    for b in (1, 4):
        for s in ss:
            da, dbu, cm, h0 = scan_inputs(torch, b, s, d, n, seed)
            dev = device_ms(torch, lambda: selective_scan(da, dbu, cm, h0=h0, return_state=True),
                            "selective_scan_kernel")
            out[f"{b},{s}"] = {"device_ms": dev,
                               "bound_ms": scan_bytes(b, s, d, n) / HBM_BYTES_PER_S * 1e3}
            del da, dbu, cm, h0
    torch.cuda.empty_cache()
    log(f"kernel selective_scan: device_ms at (B, S, {d}, {n}) {json.dumps(out)}")
    return out


def scan_stage_times(torch, seed: int) -> dict:
    """The ring body at 2 and 4 stages on the same inputs at (B, S, 4096,
    N), through the C entry with ``scan_plan``'s grid: warm device times
    in turns (4, 2, 2, 4), beside the stage count ``scan_plan`` picks, the
    measurement behind that rule."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import BODY_RING, scan_plan

    out = {}
    shapes = [(b, s, 4096, n) for n in (1, 2) for b in (1, 4) for s in (32, 512, 8192)]
    for b, s, d, n in shapes + [(1, 32768, 4096, 1)]:
        da, dbu, cm, h0 = scan_inputs(torch, b, s, d, n, seed)
        y, h_last = da.new_empty((b, s, d)), da.new_empty((b, d, n))
        plan = scan_plan(b, s, d, n)
        stream = torch.cuda.current_stream().cuda_stream

        def call(k):
            _build.launch("selective_scan", da.data_ptr(), dbu.data_ptr(), cm.data_ptr(),
                          h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), b, s, d, n,
                          BODY_RING, k, plan.grid[0], stream)

        times = {2: [], 4: []}
        for k in (4, 2, 2, 4):
            times[k].append(device_ms(torch, lambda: call(k), "selective_scan_kernel"))
        out[f"{b},{s},{d},{n}"] = {"picked": plan.stages, "2": times[2], "4": times[4]}
        del da, dbu, cm, h0, y, h_last
    torch.cuda.empty_cache()
    log(f"kernel selective_scan: ring body device_ms at 2 and 4 stages {json.dumps(out)}")
    return out


def scan_ptxas(build_log: str) -> list[str]:
    """ptxas's spill and register lines for each K8 body in the build
    log, by kernel and template arguments."""
    out, name = [], None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(selective_scan_kernel\w*?)I((?:L[ib]\d+E)+)", line)
            args = ", ".join(re.findall(r"L[ib](\d+)E", m.group(2))) if m else ""
            name = f"{m.group(1)}<{args}>" if m else None
        elif name and ("registers" in line or "spill" in line):
            out.append(f"ptxas {name}: {line.strip()}")
    return out


def reduced_model_agrees(np, torch, seed: int) -> None:
    """Phase 6(b): the reduced falcon-mamba in float32 from the same
    weights on the card and on the CPU: prefill logits and state within
    rtol = atol = 1e-4, and the greedy tokens of a short serve identical."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import SINGLE

    cfg = get_config("falcon_mamba_7b").reduced()
    api = get_model(cfg)
    models = {"cpu": api.init(cfg, seed, device="cpu", dtype=torch.float32)}
    models["cuda"] = copy.deepcopy(models["cpu"]).to("cuda")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (2, 64), dtype=np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (4, 8), dtype=np.int32)
    out = {}
    _build.reset_launches()
    for dev, model in models.items():
        logits, state = api.prefill(model, {"tokens": tokens}, cfg, SINGLE, 0)
        served = serve_requests(api, model, cfg, prompts, batch=2, max_new=4, cache_len=128)
        out[dev] = (logits.cpu(), state["ssm"].cpu(), [(r.rid, r.generated) for r in served])
    launches = _build.LAUNCHES["selective_scan"]
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4, atol=1e-4)
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    if out["cuda"][2] != out["cpu"][2]:
        raise AssertionError(f"reduced serve: card {out['cuda'][2]} != CPU {out['cpu'][2]}")
    if launches <= 0:
        raise AssertionError("reduced model: K8 never launched on the card")
    log(f"reduced falcon-mamba f32: prefill logits card vs CPU max_abs_err {err} "
        f"(tolerance 1e-4); serve tokens identical {out['cuda'][2]}; K8 launches {launches}")


def device_breakdown(prof, tag: str, wall_s: float, top: int = 8) -> float:
    """Log the device busy share of a profiled window, its top device
    operations and K8's, wherever it ranks; returns the busy seconds."""
    device = sorted(
        ((ev.device_time_total, ev.count, ev.key) for ev in prof.key_averages()
         if getattr(ev, "device_time_total", 0.0)),
        reverse=True,
    )
    busy_s = sum(us for us, _n, _key in device) / 1e6
    log(f"{tag}: device busy {busy_s:.6f} s of {wall_s:.6f} s wall "
        f"(share {busy_s / wall_s:.6f}; torch.profiler, CUDA activity)")
    for rank, (us, n, key) in enumerate(device):
        if rank < top or "selective_scan_kernel" in key:
            log(f"{tag} device: {us / 1e3:.3f} ms in {n} x {key[:90]} ({us / n:.3f} us each)")
    return busy_s


def full_width_model(np, torch, seed: int) -> dict[str, int]:
    """Phase 6(c): falcon-mamba-7b at full width and depth on the card.
    Returns K8's launches over the 32k prefill and over the serve."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import SINGLE
    from repro_torch.serve.serve_step import make_prefill_step

    cfg = get_config("falcon_mamba_7b")
    api = get_model(cfg)
    t0 = time.perf_counter()
    model = api.init(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"falcon-mamba-7b: {cfg.num_layers} layers, d_model {cfg.d_model}, d_inner "
        f"{cfg.d_inner}, N {cfg.ssm_state}, vocab {cfg.vocab_size}: {n_params} parameters, "
        f"{n_bytes} bytes, drawn on the card in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(seed)

    prefill = make_prefill_step(cfg, api, SINGLE, 0)
    # a 2k prefill to warm up, then a profiled one: where prefill time goes
    short = rng.integers(0, cfg.vocab_size, (1, 2048), dtype=np.int32)
    prefill(model, {"tokens": short})
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(model, {"tokens": short})
        torch.cuda.synchronize()
        short_s = time.perf_counter() - t0
    device_breakdown(prof, "prefill[2048 tokens, profiled]", short_s)
    del prof

    cell = SHAPES["prefill_32k"]
    tokens = rng.integers(0, cfg.vocab_size, (1, cell.seq_len), dtype=np.int32)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, state = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_k8 = _build.LAUNCHES["selective_scan"]
    chunks = cell.seq_len // cfg.scan_chunk * cfg.num_layers
    mm_flop = 2 * cell.seq_len * cfg.num_layers * (
        cfg.d_model * 2 * cfg.d_inner + cfg.d_inner * (cfg.dt_rank + 2 * cfg.ssm_state)
        + cfg.dt_rank * cfg.d_inner + cfg.d_inner * cfg.d_model)
    log(f"prefill[{cell.name} with its batch cut from {cell.global_batch} to 1]: "
        f"{cell.seq_len} tokens in {prefill_s:.6f} s wall ({cell.seq_len / prefill_s:.3f} "
        f"tokens/s); K8 launches {prefill_k8} (expected {chunks}); {mm_flop} matmul flop; "
        f"peak memory {torch.cuda.max_memory_allocated()} bytes")
    if logits.shape != (1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite or misshapen")
    if tuple(state["ssm"].shape) != (cfg.num_layers, 1, cfg.d_inner, cfg.ssm_state):
        raise AssertionError(f"prefill state {tuple(state['ssm'].shape)}")
    if prefill_k8 != chunks:
        raise AssertionError(f"prefill launched K8 {prefill_k8} times, expected {chunks}")
    del logits, state

    requests, batch, prompt_len, max_new, cache_len = 8, 4, 32, 16, 128
    prompts = rng.integers(0, cfg.vocab_size, (requests, prompt_len), dtype=np.int32)
    _build.reset_launches()
    t0 = time.perf_counter()
    finished = serve_requests(api, model, cfg, prompts, batch=batch, max_new=max_new,
                              cache_len=cache_len)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_k8 = _build.LAUNCHES["selective_scan"]
    n_tokens = sum(len(r.generated) for r in finished)
    log(f"serve[{requests} requests, batch {batch}, prompt {prompt_len}, max-new {max_new}, "
        f"cache-len {cache_len}]: served {len(finished)} requests, {n_tokens} tokens in "
        f"{serve_s:.6f} s wall ({n_tokens / serve_s:.3f} tokens/s); K8 launches {serve_k8} "
        f"({serve_k8 // cfg.num_layers} decode calls)")
    # the busy share from a profiled window of the same loop: every decode
    # call costs the same whatever the live slots, and a trace of the whole
    # serve (about 0.8 M device activities) takes minutes to read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_requests(api, model, cfg, prompts[:2, :8], batch=batch, max_new=4,
                       cache_len=cache_len)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device_breakdown(prof, f"serve window[2 requests, batch {batch}, prompt 8, max-new 4, "
                           f"profiled]", window_s)
    del prof
    bad = [r.rid for r in finished
           if len(r.generated) != max_new or not all(0 <= t < cfg.vocab_size for t in r.generated)]
    if len(finished) != requests or bad:
        raise AssertionError(f"serve: {len(finished)} of {requests} finished; bad {bad}")
    if serve_k8 <= 0:
        raise AssertionError("serve: K8 never launched")
    log(f"serve: first requests {[(r.rid, r.generated[:8]) for r in finished[:4]]}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill": prefill_k8, "serve": serve_k8}


TILE_NAMES = tuple(name for name, _r, _gf, _k in KERNELS)


def _scenario_gateway(np, code, device: str, *, num_nodes: int, q: int, num_objects: int,
                      seed: int, **cfg_kw):
    """An ObjectGateway loaded as tests/test_scenario.py's ``_gateway``
    builds it, on ``device`` with autotune off (tile counts, and so the
    modeled bill, must not depend on the card)."""
    from repro_torch.gateway import GatewayConfig, ObjectGateway
    from repro_torch.storage.netmodel import ClusterProfile

    cfg = GatewayConfig(device=device, autotune=False, **cfg_kw)
    gw = ObjectGateway(code, ClusterProfile.network_critical(), num_nodes, cfg)
    rng = np.random.default_rng(seed)
    gw.load_objects(rng.integers(0, 256, (num_objects, code.k, q), dtype=np.uint8))
    return gw


def _surge_run(np, code, num_requests: int, pacing: bool, device: str):
    """correlated_surge_setup's scenario on ``device``: (result, this
    run's tile-kernel launches, serve wall s, the setup)."""
    from repro_torch.kernels import _build
    from repro_torch.scenario import correlated_surge_setup, run_scenario

    setup = correlated_surge_setup(code, num_requests=num_requests)
    gw = _scenario_gateway(np, code, device, num_nodes=setup["num_nodes"],
                           q=setup["block_bytes"], num_objects=setup["num_objects"],
                           seed=setup["seed"], repair_pacing=pacing, **setup["gateway_kwargs"])
    _build.reset_launches()
    t0 = time.perf_counter()
    res = run_scenario(gw, setup["trace"], setup["workload"])
    wall = time.perf_counter() - t0
    launches = {name: _build.LAUNCHES[name] for name in TILE_NAMES}
    return res, launches, wall, setup


def _gray_run(np, seed: int, device: str):
    """The gray-failure trace of tests/test_integrity.py (crash +
    corruption + fail-slow, bounded at n - k) on its gateway."""
    from repro_torch.core.product_code import CoreCode
    from repro_torch.gateway import WorkloadConfig
    from repro_torch.kernels import _build
    from repro_torch.scenario import ScenarioConfig, generate_scenario, run_scenario

    code = CoreCode(9, 6, 3)
    trace = generate_scenario(ScenarioConfig(
        duration=0.5, num_nodes=60, nodes_per_rack=3, max_concurrent_failures=code.n - code.k,
        crash_rate=6.0, mean_downtime=0.08, transient_fraction=0.5, corruption_rate=8.0,
        corruption_blocks=2, slow_rate=6.0, slow_factor=0.2, mean_slow_time=0.1, seed=seed,
    ))
    gw = _scenario_gateway(
        np, code, device, num_nodes=60, q=2048, num_objects=12, seed=9,
        batch_window=0.01, cache_bytes=4 * 1024 * 1024, repair_on_failure=True,
        repair_delay=0.03, record_payloads=True, scrub_interval=0.1, decode_cost=0.002,
    )
    wl = WorkloadConfig(num_objects=12, num_requests=100, arrival_rate=300.0, seed=seed)
    _build.reset_launches()
    res = run_scenario(gw, trace, wl)
    return res, {name: _build.LAUNCHES[name] for name in TILE_NAMES}


def scenario_card_vs_cpu(np) -> dict[str, int]:
    """Phase 7(a): the canonical surge at (9, 6, 3), 200 requests, fixed
    and paced, and the gray trace of seed 0, each on the card and on the
    CPU: deterministic fingerprints equal, no block lost. Returns the
    card runs' tile-kernel launches, summed."""
    from repro_torch.core.product_code import CoreCode
    from repro_torch.kernels import _build
    from repro_torch.scenario import deterministic_fingerprint

    total = dict.fromkeys(TILE_NAMES, 0)
    runs = {f"surge[(9,6,3), {'paced' if p else 'fixed'}]":
            (lambda dev, p=p: _surge_run(np, CoreCode(9, 6, 3), 200, p, dev)[:2])
            for p in (False, True)}
    runs["gray[seed 0]"] = lambda dev: _gray_run(np, 0, dev)
    for label, run in runs.items():
        card, launches = run("cuda")
        k5 = _build.LAUNCHES["gf256_matmul_planes"]  # BlockFixer's GF(256) steps
        cpu, _ = run("cpu")
        fp_card, fp_cpu = deterministic_fingerprint(card), deterministic_fingerprint(cpu)
        log(f"scenario {label}: card fingerprint {fp_card}, CPU {fp_cpu}; "
            f"summary {json.dumps(card.summary())}; tile launches {launches}; K5 launches {k5}")
        if fp_card != fp_cpu:
            raise AssertionError(f"scenario {label}: card and CPU fingerprints differ")
        if card.blocks_lost or card.durability["unreadable_objects"]:
            raise AssertionError(f"scenario {label}: durability {card.durability}")
        for name in TILE_NAMES:
            total[name] += launches[name]
    for name in ("ragged_gf256_tiles", "ragged_xor_tiles"):
        if total[name] <= 0:
            raise AssertionError(f"scenario runs on the card never launched {name}")
    return total


def scenario_full_setting(np) -> dict[str, int]:
    """Phase 7(b): correlated_surge_setup at the benchmark's full
    setting, CORE (14, 12, 5) and 600 requests, fixed and paced on the
    card (and once more on the CPU, whose fingerprints must agree):
    every run loses no block and the paced run's simulated p99 since the
    failure is below the fixed run's. Returns the paced run's tile
    launches (the counts set to 0 just before it)."""
    from repro_torch.core.product_code import CoreCode
    from repro_torch.scenario import deterministic_fingerprint

    code = CoreCode(14, 12, 5)
    out = {}
    for pacing in (False, True):
        tag = "paced" if pacing else "fixed"
        res, launches, wall, setup = _surge_run(np, code, 600, pacing, "cuda")
        cpu = _surge_run(np, code, 600, pacing, "cpu")[0]
        fail_at, surge_end = setup["fail_at"], setup["surge_end"]
        p99 = res.p99_since(fail_at)
        window = res.p99_window(fail_at, surge_end)
        log(f"scenario surge[(14,12,5), 600 requests, {tag}]: serve wall {wall:.6f} s; "
            f"simulated p99 since failure {p99 * 1e3:.6f} ms, p99 of arrivals in "
            f"[{fail_at}, {surge_end}) {window * 1e3:.6f} ms; MTTR mean "
            f"{res.mttr_mean:.6f} s; pacing updates {len(res.report.pacing)}; blocks_lost "
            f"{res.blocks_lost}; tile launches {launches}; summary {json.dumps(res.summary())}")
        if deterministic_fingerprint(res) != deterministic_fingerprint(cpu):
            raise AssertionError(f"surge (14,12,5) {tag}: card and CPU fingerprints differ")
        if res.blocks_lost or res.durability["missing_blocks"]:
            raise AssertionError(f"surge (14,12,5) {tag}: durability {res.durability}")
        out[tag] = (p99, launches)
    if not out["paced"][0] < out["fixed"][0]:
        raise AssertionError(f"paced p99 {out['paced'][0]} not below fixed {out['fixed'][0]}")
    return out["paced"][1]


def _tree_bytes(torch, leaf) -> bytes:
    return leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def checkpoint_card_vs_cpu(np, torch, seed: int) -> None:
    """Phase 7(c), first part: on a tree of tests/test_checkpoint.py's
    make_state size, the group matrices the card's codec stores equal
    the CPU's byte for byte."""
    from repro_torch.checkpoint import CoreCheckpointer
    from repro_torch.core.product_code import CoreCode
    from repro_torch.storage.blockstore import BlockStore

    rng = np.random.default_rng(seed)
    tree = {
        "params": {"w1": rng.normal(size=(64, 128)).astype(np.float32),
                   "b1": rng.normal(size=(128,)).astype(np.float32),
                   "embed": torch.from_numpy(rng.normal(size=(1000, 64))).to(torch.bfloat16)},
        "opt": {"mu": rng.normal(size=(64, 128)).astype(np.float32),
                "nu": rng.normal(size=(64, 128)).astype(np.float32)},
        "step": np.asarray(123, dtype=np.int64),
    }
    stores = {}
    for dev in ("cuda", "cpu"):
        stores[dev] = BlockStore(num_nodes=200)
        CoreCheckpointer(stores[dev], CoreCode(9, 6, 3), block_size=1 << 12,
                         device=dev).save(1, tree)
    card, cpu = stores["cuda"], stores["cpu"]
    same = card.checksums == cpu.checksums and all(
        np.array_equal(blk, cpu.blocks[key]) for key, blk in card.blocks.items())
    if not same or card.placement != cpu.placement:
        raise AssertionError("checkpoint: card and CPU group matrices differ")
    log(f"checkpoint make_state tree: {len(card.blocks)} blocks identical on card and CPU")


def checkpoint_full_width(np, torch, seed: int) -> None:
    """Phase 7(c): falcon-mamba-7b's state_dict at full width, cut to 2
    of its 64 layers, CORE-checkpointed on the card at (14, 12, 5) with
    64 KiB blocks over 100 nodes; two nodes holding blocks of group 0
    fail; restore is bit-equal; repair recovers every block and each
    rebuilt block matches its digest."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import CoreCheckpointer
    from repro_torch.configs import get_config
    from repro_torch.core.product_code import CoreCode
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_model
    from repro_torch.storage.blockstore import BlockStore

    full = get_config("falcon_mamba_7b")
    cfg = dataclasses.replace(full, num_layers=2)
    model = get_model(cfg).init(cfg, seed, device="cuda")
    state = model.state_dict()
    n_bytes = sum(t.numel() * t.element_size() for t in state.values())
    log(f"checkpoint state: falcon-mamba-7b d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
        f"vocab {cfg.vocab_size}, {cfg.num_layers} of {full.num_layers} layers: "
        f"{len(state)} tensors, {n_bytes} bytes "
        f"({sorted({str(t.dtype) for t in state.values()})})")
    store = BlockStore(num_nodes=100)
    code = CoreCode(14, 12, 5)
    ckpt = CoreCheckpointer(store, code, block_size=1 << 16, device="cuda")
    _build.reset_launches()
    man = ckpt.save(1, state)
    groups = len(man.group_ids)
    log(f"checkpoint save: {man.total_bytes} bytes in {groups} groups of {code} x 65536-byte "
        f"blocks, {len(store.blocks)} blocks stored, wall {man.save_seconds:.6f} s")

    # one group's encode on the card, profiled: the codec's CUDA work per group
    from repro_torch.checkpoint import partition

    group_bytes = code.k * code.t << 16
    head = model.embed.detach().reshape(-1)[: group_bytes // model.embed.element_size()]
    one = partition.stream_to_objects(_tree_bytes(torch, head), 1 << 16, code.k, code.t)[0][0]
    ckpt.codec.encode(one)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ckpt.codec.encode(one)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
    kernels = [(ev.device_time_total, ev.count, ev.key) for ev in prof.key_averages()
               if getattr(ev, "device_time_total", 0.0)]
    log(f"checkpoint encode of one group (5 x 12 x 65536 bytes): wall {enc_s * 1e3:.6f} ms, "
        f"{sum(n for _us, n, _k in kernels)} CUDA activities, device "
        f"{sum(us for us, _n, _k in kernels) / 1e3:.6f} ms (torch.profiler)")
    for us, n, key in sorted(kernels, reverse=True)[:4]:
        log(f"checkpoint encode device: {us / 1e3:.3f} ms in {n} x {key[:90]}")
    del prof

    gid = man.group_ids[0]
    victims = [store.node_of((gid, 0, 0)), store.node_of((gid, 1, 3))]
    store.fail_nodes(victims)
    hit = sum(1 for key, node in store.placement.items() if node in victims)
    t0 = time.perf_counter()
    restored, rep = ckpt.restore(1)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    bad = [k for k, v in state.items()
           if restored[k].dtype != v.dtype or tuple(restored[k].shape) != tuple(v.shape)
           or _tree_bytes(torch, restored[k]) != _tree_bytes(torch, v)]
    log(f"checkpoint restore with nodes {victims} down ({hit} blocks lost): wall "
        f"{restore_s:.6f} s, {rep.blocks_fetched} blocks / {rep.bytes_fetched} bytes fetched, "
        f"compute {rep.compute_time:.6f} s; {len(state) - len(bad)} of {len(state)} tensors "
        f"bit-equal")
    if bad or list(restored) != list(state):
        raise AssertionError(f"checkpoint restore differs in {bad[:5]}")
    del restored
    t0 = time.perf_counter()
    fixed = ckpt.repair(1)
    torch.cuda.synchronize()
    repair_s = time.perf_counter() - t0
    unverified = [key for key in store.blocks if not store.verify(key)]
    lost = sum(int(store.failure_matrix(g, code.rows, code.n).sum()) for g in man.group_ids)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    log(f"checkpoint repair: wall {repair_s:.6f} s, {fixed.blocks_repaired} blocks repaired "
        f"from {fixed.blocks_fetched} fetched ({fixed.bytes_fetched} bytes), recovered "
        f"{fixed.recovered}; digests verified {len(store.blocks) - len(unverified)} of "
        f"{len(store.blocks)}; hand-written kernel launches over save, restore and repair "
        f"{launches or 0} (K5 for BlockFixer's GF(256) steps; its XOR and the codec plain "
        f"torch)")
    if not fixed.recovered or unverified or lost or fixed.blocks_repaired != hit:
        raise AssertionError(f"checkpoint repair: recovered {fixed.recovered}, "
                             f"{len(unverified)} bad digests, {lost} still missing")
    del model, state
    gc.collect()
    torch.cuda.empty_cache()


def storage_paths(np, torch, seed: int) -> dict[str, dict[str, int]]:
    """Phase 7: the scenario engine and the CORE checkpoint layer on the
    card. Returns the tile launches of 7(a) and 7(b)."""
    t0 = time.perf_counter()
    card_vs_cpu = scenario_card_vs_cpu(np)
    log(f"phase 7(a) done in {time.perf_counter() - t0:.1f} s")
    full = scenario_full_setting(np)
    log(f"phase 7(b) done in {time.perf_counter() - t0:.1f} s")
    checkpoint_card_vs_cpu(np, torch, seed)
    checkpoint_full_width(np, torch, seed)
    log(f"phase 7(c) done in {time.perf_counter() - t0:.1f} s")
    return {"7a": card_vs_cpu, "7b": full}


def _bits_equal(torch, a, b) -> bool:
    """Same dtype, shape and bytes (NaN and -0.0 compared as bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.detach().contiguous().reshape(-1).view(torch.uint8),
                       b.detach().to(a.device).contiguous().reshape(-1).view(torch.uint8))


def _grads_close(torch, got, want, tag: str) -> float:
    """Gradient leaves card vs CPU: every leaf finite and within 1e-3 of
    its max |CPU| (plus 1e-12, so an all-zero leaf must match exactly).
    Returns the largest |diff| / max |CPU| for the log."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        diff, scale = float((g - w).abs().max()), float(w.abs().max())
        if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all())
                and diff <= 1e-3 * scale + 1e-12):
            raise AssertionError(f"{tag}: gradient leaf {i} max |diff| {diff}, max |CPU| "
                                 f"{scale} (tolerance 1e-3 of it, finite)")
        worst = max(worst, diff / scale if scale else 0.0)
    return worst



# phase 8(a)'s train steps card vs CPU, each at reduced(num_layers=2)
TRAIN_TWINS = ("falcon_mamba_7b", "qwen2_72b", "olmoe_1b_7b")


def train_step_card_vs_cpu(np, torch, seed: int, arch: str, phase: str = "8(a)",
                           layers: int = 2, param_tol: float | None = 1e-5) -> None:
    """One ``make_train_step`` of ``arch`` at ``reduced(num_layers=layers)``
    in float32 (TF32 off) from the same weights on the card and on the
    CPU (carried to the card through ``models.convert`` both ways): loss
    within rtol = atol = 1e-4, each gradient leaf within 1e-3 of its max
    |CPU|, the card's parameters after the update within ``param_tol``
    (phase 8(a): 1e-5, a tenth of the step's learning rate, 1e-4) of the
    CPU's step (logged and not held where ``param_tol`` is None), and
    within 1e-5 of the CPU's AdamW applied to the gradients the card's
    step passed it; no kernel launched.

    AdamW's first step moves an element by lr * g / (|g| + 1e-8),
    normalized per element: an element whose gradient is small beside
    its leaf's largest keeps the leaf's absolute rounding difference,
    and moves by a fraction of lr where the two devices' sums differ in
    their last bits. The worst element is logged, with its gradient on
    both devices."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.kernels import _build
    from repro_torch.models import convert
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import SINGLE
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg = get_config(arch).reduced(num_layers=layers)
    api = get_model(cfg)
    oc = opt.OptConfig(lr=1e-4, warmup_steps=1)
    cpu = api.init(cfg, seed, device="cpu", dtype=torch.float32).requires_grad_(True)
    # the card's copy goes through models/convert.py both ways
    models = {"cpu": cpu, "cuda": convert.from_jax(convert.to_reference_tree(cpu), cfg,
                                                   device="cuda", trainable=True)}
    batch = SyntheticPipeline(cfg, 32, 2, seed).batch_at(0)
    step = ts.make_train_step(cfg, api, SINGLE, oc)
    before = convert.stacked_tree(cpu, [p.detach().clone() for p in cpu.parameters()])
    out, passed = {}, {}
    real_update = opt.adamw_update_

    def spy(grads, state, params, c):  # the gradients the step hands AdamW
        passed[params_dev] = convert.tree_to(grads, "cpu")
        return real_update(grads, state, params, c)

    _build.reset_launches()
    opt.adamw_update_ = spy
    try:
        for params_dev, model in models.items():
            loss = api.loss(model, batch, cfg, SINGLE)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            state = ts.TrainState(model, opt.init_opt_state(convert.stacked_tree(model), oc),
                                  torch.zeros((), dtype=torch.int32, device=model.device))
            state, metrics = step(state, batch)
            out[params_dev] = (float(metrics["loss"]), [g.cpu() for g in grads],
                               convert.to_reference_tree(state.params))
    finally:
        opt.adamw_update_ = real_update
    launched = {name: n for name, n in _build.LAUNCHES.items() if n}
    loss_err = abs(out["cuda"][0] - out["cpu"][0])
    grad_err = _grads_close(torch, out["cuda"][1], out["cpu"][1], f"phase {phase} {arch}")
    # the CPU's AdamW on the card's gradients: the card's own arithmetic
    own, _, _ = opt.adamw_update(passed["cuda"], opt.init_opt_state(before, oc), before, oc)
    card, ref, g = (opt.tree_leaves(t) for t in (out["cuda"][2], out["cpu"][2], passed["cpu"]))
    own = opt.tree_leaves(own)
    param_err = max(float((a - b).abs().max()) for a, b in zip(card, ref))
    own_err = max(float((a - b).abs().max()) for a, b in zip(card, own))
    leaf = max(range(len(card)), key=lambda i: float((card[i] - ref[i]).abs().max()))
    at = int((card[leaf] - ref[leaf]).abs().argmax())
    g_card = opt.tree_leaves(passed["cuda"])[leaf].reshape(-1)[at]
    log(f"phase {phase} reduced {arch} ({cfg.num_layers} layers) f32 train step, card vs CPU: "
        f"loss {out['cuda'][0]} vs {out['cpu'][0]} (|diff| {loss_err}, tolerance 1e-4 + 1e-4 "
        f"rel); gradient leaves max |diff| / max |CPU| {grad_err} (tolerance 1e-3); the card's "
        f"update against the CPU's AdamW on the card's gradients {own_err} (tolerance 1e-5); "
        f"params after the update max |diff| {param_err} ("
        f"{'not held' if param_tol is None else f'tolerance {param_tol}'}), at an element whose "
        f"gradient is {float(g[leaf].reshape(-1)[at])} on the CPU and {float(g_card)} on the "
        f"card (its leaf's max |CPU| {float(g[leaf].abs().max())}); kernel launches "
        f"{launched or 'none'}")
    if not (loss_err <= 1e-4 + 1e-4 * abs(out["cpu"][0]) and own_err <= 1e-5
            and (param_tol is None or param_err <= param_tol)):
        raise AssertionError(f"phase {phase}: {arch}'s train step on the card differs from the "
                             f"CPU's")
    if launched:
        raise AssertionError(f"phase {phase}: {arch}'s train step launched {launched}")


def dense_trainer_restores(np, torch, seed: int) -> None:
    """Phase 8(a): the JAX package's own training case on the card, the
    reduced qwen2 cut to 2 layers (``Trainer``, batch 2 x seq 32, CORE
    checkpoints at steps 3 and 6 over 20 nodes): two nodes failed,
    ``restore_latest`` bit-equal to the state in memory, ``ckpt.repair``
    recovered, and steps 7-8 resumed from the restored state give the
    in-memory state's losses within 1e-3 relative (as phase 8(b) holds
    them)."""
    from repro_torch.checkpoint import partition
    from repro_torch.configs import get_config
    from repro_torch.models import convert
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.loop import LoopConfig, Trainer

    cfg = get_config("qwen2_72b").reduced(num_layers=2)
    lc = LoopConfig(steps=6, ckpt_every=3, log_every=100, seq_len=32, global_batch=2,
                    seed=seed, num_nodes=20)
    tr = Trainer(cfg, lc, opt.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=10),
                 device="cuda")
    state = tr.run()

    def leaves(st):
        return partition.flatten(ts.TrainState(convert.to_reference_tree(st.params), st.opt,
                                               st.step))[0]

    losses = [m["loss"] for m in tr.metrics_log]
    tr.store.fail_nodes([0, 1])
    restored = tr.restore_latest()
    saved, back = leaves(state), leaves(restored)
    equal = len(saved) == len(back) and all(_bits_equal(torch, a, b)
                                            for a, b in zip(saved, back))
    fetched = tr.last_restore_report.blocks_fetched
    tr.store.heal_node(0)
    tr.store.heal_node(1)
    rep = tr.ckpt.repair(6)
    tr.run(state=restored, until=8)
    resumed = [m["loss"] for m in tr.metrics_log[6:]]
    tr.run(state=state, until=8)
    in_memory = [m["loss"] for m in tr.metrics_log[8:]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, in_memory))
    log(f"phase 8(a) reduced qwen2 Trainer on the card: losses {losses}; nodes 0, 1 down: "
        f"{len(saved)} leaves restored bit-equal {equal} ({fetched} blocks fetched); repair "
        f"recovered {rep.recovered}; steps 7-8 resumed {resumed} vs in memory {in_memory} "
        f"(largest relative difference {rel}, tolerance 1e-3)")
    if not (equal and fetched > 0 and rep.recovered and rel <= 1e-3
            and all(np.isfinite(losses + resumed))):
        raise AssertionError("phase 8(a): the reduced qwen2 Trainer's restore or resume failed")
    del tr, state, restored


def train_card_vs_cpu(np, torch, seed: int) -> None:
    """Phase 8(a): the training path against the CPU and against K8. One
    train step each of the reduced falcon-mamba, qwen2 and olmoe card vs
    CPU (``train_step_card_vs_cpu``); the reduced qwen2 ``Trainer``'s
    kill -> degraded restore -> repair -> resume on the card; then the
    training scan ``_chunk_scan`` (and its output einsum) on the card
    against K8's forward at the prefill chunk (1, 128, 8192, 16): y and
    h_last within rtol = atol = 2e-5. Then K8 given an operand that
    requires grad raises, launching nothing."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.models.mamba import _chunk_scan

    for arch in TRAIN_TWINS:
        train_step_card_vs_cpu(np, torch, seed, arch)
    dense_trainer_restores(np, torch, seed)

    da, dbu, cm, h0 = scan_inputs(torch, 1, 128, 8192, 16, seed)
    with torch.no_grad():
        h_all, h_last = _chunk_scan(da, dbu, h0)
        y = torch.einsum("bcdn,bcn->bcd", h_all, cm)
        k8_y, k8_h = selective_scan(da, dbu, cm, h0=h0, return_state=True)
    torch.cuda.synchronize()
    y_err = float((y - k8_y).abs().max())
    h_err = float((h_last - k8_h).abs().max())
    log(f"phase 8(a) _chunk_scan + einsum vs K8 at (1, 128, 8192, 16): y max_abs_err {y_err}, "
        f"h_last max_abs_err {h_err} (tolerance rtol = atol = 2e-5)")
    torch.testing.assert_close(y, k8_y, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(h_last, k8_h, rtol=2e-5, atol=2e-5)
    del h_all, y, k8_y
    _build.reset_launches()
    dbu.requires_grad_(True)
    try:
        selective_scan(da, dbu, cm, h0=h0, return_state=True)
    except ValueError as err:
        log(f"phase 8(a) K8 on an operand that requires grad raises: {err}")
    else:
        raise AssertionError("phase 8(a): K8 took an operand that requires grad")
    if _build.LAUNCHES["selective_scan"]:
        raise AssertionError("phase 8(a): K8 launched on an operand that requires grad")
    del da, dbu, cm, h0
    torch.cuda.empty_cache()


def train_full_width(np, torch, seed: int) -> float:
    """Phase 8(b): falcon-mamba-7b at full width, cut to 2 of its 64
    layers, trained on the card by ``Trainer.run`` for 6 steps at the
    launcher's defaults (global batch 8, seq 256, lr 3e-4 with one
    warmup step, bf16 weights from the seed) with a CORE checkpoint at
    step 6; one more step from the in-memory state under the profiler;
    two nodes of group 0 failed, ``restore_latest`` bit-equal to the
    saved state, ``ckpt.repair`` recovered, and 2 steps resumed from the
    restored state, whose step-7 loss is within 1e-3 relative of the
    in-memory state's. K8 is never launched. Returns the median step
    wall (steps 2-6)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import partition
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import convert
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.loop import LoopConfig, Trainer

    full = get_config("falcon_mamba_7b")
    cfg = dataclasses.replace(full, num_layers=2)
    steps = 6
    lc = LoopConfig(steps=steps, ckpt_every=steps, log_every=1, seq_len=256, global_batch=8,
                    seed=seed, num_nodes=100)
    oc = opt.OptConfig(lr=3e-4, warmup_steps=min(20, steps // 10 + 1), decay_steps=steps)
    tr = Trainer(cfg, lc, oc, device="cuda")
    t0 = time.perf_counter()
    state = tr.init_state()
    torch.cuda.synchronize()
    params = list(state.params.parameters())
    n_params = sum(p.numel() for p in params)
    p_bytes = sum(p.numel() * p.element_size() for p in params)
    tokens = lc.global_batch * lc.seq_len
    log(f"phase 8(b) falcon-mamba-7b d_model {cfg.d_model}, d_inner {cfg.d_inner}, N "
        f"{cfg.ssm_state}, dt_rank {cfg.dt_rank}, vocab {cfg.vocab_size}, {cfg.num_layers} of "
        f"{full.num_layers} layers: {n_params} parameters, {p_bytes} bytes, f32 m and v "
        f"{8 * n_params} bytes, state built on the card in {time.perf_counter() - t0:.3f} s; "
        f"batch {lc.global_batch} x seq {lc.seq_len} = {tokens} tokens a step")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    state = tr.run(state)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    walls = [rec["sec"] for rec in tr.metrics_log]
    med = statistics.median(walls[1:])
    man = tr.ckpt.manifests[steps]
    for rec in tr.metrics_log:
        log(f"phase 8(b) step {rec['step']}: wall {rec['sec']:.6f} s, loss {rec['loss']:.6f}, "
            f"grad norm {rec['grad_norm']:.6f}")
    log(f"phase 8(b) train: median step wall (steps 2-{steps}) {med:.6f} s, "
        f"{tokens / med:.3f} tokens/s; max_memory_allocated {peak} bytes; Trainer.run "
        f"{run_s:.3f} s with the save; CORE checkpoint at step {steps}: {man.total_bytes} "
        f"bytes in {len(man.group_ids)} groups of {tr.ckpt.code}, save wall "
        f"{man.save_seconds:.6f} s")
    losses = [rec["loss"] for rec in tr.metrics_log]
    if len(losses) != steps or not all(np.isfinite(losses)) or int(state.step) != steps:
        raise AssertionError(f"phase 8(b): losses {losses}, step {int(state.step)}")

    saved = partition.flatten(ts.TrainState(convert.stacked_tree(state.params), state.opt,
                                            state.step))[0]
    store, code = tr.store, tr.ckpt.code
    gid = man.group_ids[0]
    victims = [store.node_of((gid, 0, 0)), store.node_of((gid, 1, 3))]
    store.fail_nodes(victims)
    hit = sum(1 for node in store.placement.values() if node in victims)
    t0 = time.perf_counter()
    restored = tr.restore_latest()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    rep = tr.last_restore_report
    back = partition.flatten(ts.TrainState(convert.stacked_tree(restored.params),
                                           restored.opt, restored.step))[0]
    equal = len(back) == len(saved) and all(_bits_equal(torch, a, b) for a, b in zip(saved, back))
    log(f"phase 8(b) restore_latest with nodes {victims} down ({hit} blocks lost): wall "
        f"{restore_s:.6f} s, {rep.blocks_fetched} blocks / {rep.bytes_fetched} bytes fetched; "
        f"{len(saved)} leaves bit-equal {equal}")
    if not equal or rep.blocks_fetched <= 0:
        raise AssertionError("phase 8(b): the restored state differs from the saved one")
    del saved, back
    t0 = time.perf_counter()
    fixed = tr.ckpt.repair(steps)
    repair_s = time.perf_counter() - t0
    lost = sum(int(store.failure_matrix(g, code.rows, code.n).sum()) for g in man.group_ids)
    log(f"phase 8(b) repair: wall {repair_s:.6f} s, {fixed.blocks_repaired} blocks repaired "
        f"from {fixed.blocks_fetched} fetched ({fixed.bytes_fetched} bytes), recovered "
        f"{fixed.recovered}, {lost} blocks still missing")
    if not fixed.recovered or lost or fixed.blocks_repaired != hit:
        raise AssertionError(f"phase 8(b): repair recovered {fixed.recovered}, {lost} missing")

    # step 7 from the state in memory, profiled: where a step's time goes
    batch = tr.pipeline.device_batch(steps, tr.dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = tr.step_fn(state, batch)
        memory_loss = float(metrics["loss"])
        prof_s = time.perf_counter() - t0
    device_breakdown(prof, "phase 8(b) train step 7 (profiled)", prof_s)
    del prof, state
    torch.cuda.empty_cache()
    resumed = []
    for step in range(steps, steps + 2):
        t0 = time.perf_counter()
        restored, metrics = tr.step_fn(restored, tr.pipeline.device_batch(step, tr.dev))
        resumed.append(float(metrics["loss"]))
        log(f"phase 8(b) resumed step {step + 1}: wall {time.perf_counter() - t0:.6f} s, "
            f"loss {resumed[-1]:.6f}")
    rel = abs(resumed[0] - memory_loss) / abs(memory_loss)
    k8 = _build.LAUNCHES["selective_scan"]
    log(f"phase 8(b) step-7 loss resumed {resumed[0]} vs in memory {memory_loss} (relative "
        f"{rel}, tolerance 1e-3); step {int(restored.step)}; K8 launches over phase 8(b) {k8}")
    if rel > 1e-3 or int(restored.step) != steps + 2 or not all(np.isfinite(resumed)):
        raise AssertionError("phase 8(b): the resumed run differs from the in-memory one")
    if k8:
        raise AssertionError(f"phase 8(b): training launched K8 {k8} times")
    del restored, tr
    gc.collect()
    torch.cuda.empty_cache()
    return med


def train_dense_full_width(np, torch, seed: int, arch: str, phase: str, **cut) -> None:
    """Phase 8(c): starcoder2-15b at full width, ``cut`` to 8 of its 40
    layers with ``remat_block=2`` (four blocks of two: the two-level remat),
    trained by ``Trainer.run`` for 6 steps at the launcher's defaults
    (global batch 8, seq 256, lr 3e-4 with one warmup step, bf16 weights
    from the seed). ``ckpt_every`` lies beyond the run, and the save the
    loop makes at its last step is not made (``save`` records the step):
    the state is 44 GB, and phase 8(b) measures the CORE save. Each
    step's wall, loss and grad norm, the median step wall, tokens/s and
    peak memory; step 7 under the profiler. No kernel is launched.
    Phase 11(c) runs the same on seamless-m4t-large-v2 at full width and
    full depth (24 + 24 layers, per-layer remat; each batch also carries
    its 8 x 1,024 encoder frames)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import LoopConfig, Trainer

    class UnsavedTrainer(Trainer):
        def save(self, state):
            self.unsaved.append(int(state.step))
            return argparse.Namespace(group_ids=(), total_bytes=0, save_seconds=0.0)

    full = get_config(arch)
    cfg = dataclasses.replace(full, **cut)
    steps = 6
    lc = LoopConfig(steps=steps, ckpt_every=steps + 1, log_every=1, seq_len=256,
                    global_batch=8, seed=seed, num_nodes=100)
    oc = opt.OptConfig(lr=3e-4, warmup_steps=min(20, steps // 10 + 1), decay_steps=steps)
    gc.collect()
    torch.cuda.empty_cache()
    tr = UnsavedTrainer(cfg, lc, oc, device="cuda")
    tr.unsaved = []
    t0 = time.perf_counter()
    state = tr.init_state()
    torch.cuda.synchronize()
    n_params, n_bytes, w_params, w_bytes = _param_counts(state.params)
    tokens = lc.global_batch * lc.seq_len
    frames = lc.global_batch * cfg.num_stub_tokens if cfg.family == "encdec" else 0
    log(f"phase {phase} {cfg.name} d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.num_layers} of {full.num_layers} layers, remat_block "
        f"{cfg.remat_block}: {n_params} parameters, {n_bytes} bytes ({w_bytes} of bf16 weights), "
        f"f32 m and v {8 * n_params} bytes, state built on the card in "
        f"{time.perf_counter() - t0:.3f} s; batch {lc.global_batch} x seq {lc.seq_len} = "
        f"{tokens} tokens a step" + (f" and {frames} encoder frames" if frames else ""))
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    state = tr.run(state)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for rec in tr.metrics_log:
        log(f"phase {phase} step {rec['step']}: wall {rec['sec']:.6f} s, loss {rec['loss']:.6f}, "
            f"grad norm {rec['grad_norm']:.6f}")
    med = statistics.median([rec["sec"] for rec in tr.metrics_log][1:])
    # 6 x parameters x tokens, and each remat level's forward again; the
    # encdec's encoder layers see the frames, its decoder the tokens
    remat = 2 * (2 if cfg.remat_block else 1)
    if frames:
        enc = sum(p.numel() for p in state.params.enc.parameters())
        flop = (6 + remat) * (enc * frames + (n_params - enc - cfg.vocab_size * cfg.d_model)
                              * tokens)
    else:
        flop = (6 + remat) * (n_params - cfg.vocab_size * cfg.d_model) * tokens
    log(f"phase {phase} train: median step wall (steps 2-{steps}) {med:.6f} s, "
        f"{tokens / med:.3f} tokens/s; max_memory_allocated {peak} bytes; Trainer.run "
        f"{run_s:.3f} s; saves made at steps {tr.unsaved} were not; about {flop} matmul flop a "
        f"step ({flop / BF16_FLOPS_PER_S:.6f} s at the bf16 peak)")
    losses = [rec["loss"] for rec in tr.metrics_log]
    if len(losses) != steps or not all(np.isfinite(losses)) or int(state.step) != steps:
        raise AssertionError(f"phase {phase}: losses {losses}, step {int(state.step)}")
    batch = tr.pipeline.device_batch(steps, tr.dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = tr.step_fn(state, batch)
        loss = float(metrics["loss"])
        prof_s = time.perf_counter() - t0
    device_breakdown(prof, f"phase {phase} train step 7 (profiled, loss {loss:.6f})", prof_s,
                     top=12)
    launched = {name: n for name, n in _build.LAUNCHES.items() if n}
    log(f"phase {phase} kernel launches: {launched or 'none'}")
    if launched or not np.isfinite(loss):
        raise AssertionError(f"phase {phase}: launches {launched}, step-7 loss {loss}")
    del prof, state, tr, batch
    gc.collect()
    torch.cuda.empty_cache()


def train_paths(np, torch, seed: int) -> float:
    """Phase 8: the training path on the card; returns 8(b)'s median step
    wall (phase 12(a) logs its own beside it)."""
    t0 = time.perf_counter()
    train_card_vs_cpu(np, torch, seed)
    log(f"phase 8(a) done in {time.perf_counter() - t0:.1f} s")
    wall_8b = train_full_width(np, torch, seed)
    log(f"phase 8(b) done in {time.perf_counter() - t0:.1f} s")
    train_dense_full_width(np, torch, seed, "starcoder2_15b", "8(c)", num_layers=8,
                           remat_block=2)
    log(f"phase 8(c) done in {time.perf_counter() - t0:.1f} s")
    return wall_8b


DENSE_IDS = ("qwen2_72b", "mistral_large_123b", "starcoder2_15b", "command_r_35b",
             "pixtral_12b")
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), for the
# prefill's least time beside its HBM bytes
BF16_FLOPS_PER_S = 989e12


def _bf16_cache_close(torch, got, want, tag: str) -> int:
    """A bf16 cache card vs CPU: rtol = atol = 1e-4, except one-ulp bf16
    neighbours (float32-sized differences upstream round a k or v to the
    next bf16 value), at most 1e-3 of the elements. Returns their count."""
    got = got.cpu()
    bad = ~torch.isclose(got.float(), want.float(), rtol=1e-4, atol=1e-4)
    flips = bad & ((got.view(torch.int16).int() - want.view(torch.int16).int()).abs() == 1)
    if int(flips.sum()) > 1e-3 * got.numel() or bool((bad & ~flips).any()):
        raise AssertionError(f"{tag}: {int((bad & ~flips).sum())} elements beyond 1e-4, "
                             f"{int(flips.sum())} one-ulp neighbours of {got.numel()}")
    return int(flips.sum())


def _caches_close(torch, got, want, tag: str) -> int:
    """Every leaf of a cache tree card vs CPU: bf16 leaves as
    ``_bf16_cache_close``, the rest within rtol = atol = 1e-4. Returns
    the one-ulp neighbours counted."""
    from repro_torch.models.stack import tree_paths

    got, want = tree_paths(got), tree_paths(want)
    if set(got) != set(want):
        raise AssertionError(f"{tag}: cache leaves {sorted(got)} != {sorted(want)}")
    flips = 0
    for name, leaf in want.items():
        if leaf.dtype == torch.bfloat16:
            flips += _bf16_cache_close(torch, got[name], leaf, f"{tag} {name}")
        else:
            torch.testing.assert_close(got[name].cpu(), leaf, rtol=1e-4, atol=1e-4)
    return flips


def reduced_agrees(np, torch, seed: int, ids=None, phase: str = "9(a)") -> None:
    """Phase 9(a): the five dense / vlm ids at ``reduced()`` (mistral at
    ``reduced(num_layers=8, remat_block=2)``, the two-level remat), in
    float32 from the same weights on the card and on the CPU (the card's
    through ``models.convert`` both ways): ``lm_loss`` within 1e-4 and
    each gradient leaf within 1e-3 of its max |CPU|; prefill logits
    within rtol = atol = 1e-4 and its bf16 caches too but for one-ulp
    neighbours; two decode steps from the CPU's prefill cache cast to
    float32, logits and caches within 1e-4; the decode-after-prefill
    oracle of tests/test_models.py (4 gold tokens decoded after a
    16-token prefill reproduce the 20-token prefill's logits within
    0.05) on the card; the greedy tokens of a short ``serve_requests``
    identical; then bf16 weights drawn on the card: prefill and decode
    logits finite. Phase 10(a) runs the same on the moe ids (``ids``),
    but for the oracle: prefill (S tokens) and decode (one) route with
    other expert capacities, so decode need not reproduce prefill.
    Phase 11(a) runs it on the hybrid and encdec ids: every leaf of the
    hybrid's nested cache compared, the encdec batch carrying 8
    ``src_embed`` frames, and the hybrid's oracle prefilling 76 tokens
    (past its 64-slot window, so the ring has wrapped) before the 4
    decoded ones."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import convert
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import SINGLE
    from repro_torch.models.stack import tree_map, tree_paths

    rng = np.random.default_rng(seed)
    for arch in ids or DENSE_IDS:
        kw = dict(num_layers=8, remat_block=2) if arch == "mistral_large_123b" else {}
        cfg = get_config(arch).reduced(**kw)
        api = get_model(cfg)
        cpu = api.init(cfg, seed, device="cpu", dtype=torch.float32)
        models = {"cpu": cpu, "cuda": convert.from_jax(convert.to_reference_tree(cpu), cfg,
                                                       device="cuda")}
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
        batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1)}
        if cfg.family in ("vlm", "encdec"):
            pe = rng.standard_normal((2, cfg.num_stub_tokens, cfg.d_model)).astype(np.float32)
            key = "patch_embed" if cfg.family == "vlm" else "src_embed"
            batch[key] = torch.from_numpy(pe).to(torch.bfloat16)
        prefix = cfg.num_stub_tokens if cfg.family == "vlm" else 0
        pos = 64 + prefix
        out = {}
        for dev, model in models.items():
            model.requires_grad_(True)
            dbatch = {k: v.to(model.device) for k, v in batch.items()}
            loss = api.loss(model, dbatch, cfg, SINGLE)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            model.requires_grad_(False)
            pbatch = {k: v for k, v in dbatch.items() if k != "labels"}
            out[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                        api.prefill(model, pbatch, cfg, SINGLE, 128))
        loss_err = abs(out["cuda"][0] - out["cpu"][0])
        grad_err = _grads_close(torch, out["cuda"][1], out["cpu"][1], f"phase {phase} {arch}")
        if not loss_err <= 1e-4 + 1e-4 * abs(out["cpu"][0]):
            raise AssertionError(f"phase {phase} {arch}: loss |diff| {loss_err}")
        (cl, cc), (gl, gc_) = out["cpu"][2], out["cuda"][2]
        torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
        flips = _caches_close(torch, gc_, cc, f"{arch} prefill")
        prefill_err = float((gl.cpu() - cl).abs().max())
        caches = {"cpu": tree_map(lambda v: v.float(), cc)}
        caches["cuda"] = tree_map(lambda v: v.cuda(), caches["cpu"])
        nxt = cl.argmax(-1, keepdim=True)
        decode_err = 0.0
        for i in range(2):
            step = {}
            for dev, model in models.items():
                step[dev] = api.decode(model, nxt.to(model.device), caches[dev], pos + i, cfg,
                                       SINGLE, None)
                caches[dev] = step[dev][1]
            torch.testing.assert_close(step["cuda"][0].cpu(), step["cpu"][0], rtol=1e-4,
                                       atol=1e-4)
            got, want = tree_paths(step["cuda"][1]), tree_paths(step["cpu"][1])
            for k, leaf in want.items():
                torch.testing.assert_close(got[k].cpu(), leaf, rtol=1e-4, atol=1e-4)
            decode_err = max(decode_err, float((step["cuda"][0].cpu() - step["cpu"][0])
                                               .abs().max()))
            nxt = step["cpu"][0].argmax(-1, keepdim=True)

        # the decode-after-prefill oracle, on the card
        oracle_err = None
        if cfg.family != "moe":
            start = 76 if cfg.family == "hybrid" else 16
            gold = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, start + 4))).cuda()
            stub = {k: v.cuda() for k, v in batch.items() if k in ("patch_embed", "src_embed")}
            card = models["cuda"]
            _, cache = api.prefill(card, {"tokens": gold[:, :start], **stub}, cfg, SINGLE, 64)
            for i in range(4):
                ld, cache = api.decode(card, gold[:, start + i : start + 1 + i], cache,
                                       start + i + prefix, cfg, SINGLE, None)
            lp, _ = api.prefill(card, {"tokens": gold, **stub}, cfg, SINGLE, 64)
            torch.testing.assert_close(ld, lp, rtol=0.05, atol=0.05)
            oracle_err = float((ld - lp).abs().max())
            del card, cache
        else:
            oracle_err = "not run (prefill and decode route with other capacities)"

        prompts = rng.integers(0, cfg.vocab_size, (4, 8), dtype=np.int32)
        served = {dev: [(r.rid, r.generated) for r in serve_requests(
            api, m, cfg, prompts, batch=2, max_new=4, cache_len=128)]
            for dev, m in models.items()}
        if served["cuda"] != served["cpu"]:
            raise AssertionError(f"phase {phase} {arch}: serve card {served['cuda']} != CPU "
                                 f"{served['cpu']}")
        del models, cpu
        bf16 = api.init(cfg, seed, device="cuda")
        bl, bc = api.prefill(bf16, {k: v.cuda() for k, v in batch.items() if k != "labels"},
                             cfg, SINGLE, 128)
        dl, _ = api.decode(bf16, bl.argmax(-1, keepdim=True), bc, pos, cfg, SINGLE, None)
        if not (bool(torch.isfinite(bl).all()) and bool(torch.isfinite(dl).all())):
            raise AssertionError(f"phase {phase} {arch}: bf16 logits not finite")
        del bf16, bc
        log(f"phase {phase} {arch} ({cfg.num_layers} layers, remat_block {cfg.remat_block}) f32 "
            f"card vs CPU: loss |diff| {loss_err}, gradient leaves {grad_err} of max |CPU| "
            f"(tolerance 1e-3); prefill logits max_abs_err {prefill_err}, caches within 1e-4 "
            f"but {flips} one-ulp bf16 neighbours; decode logits max_abs_err {decode_err} "
            f"(tolerance 1e-4); decode-after-prefill oracle max_abs_err {oracle_err} "
            f"(tolerance 0.05); serve tokens identical {served['cuda'][:2]}; bf16 finite")
    torch.cuda.empty_cache()


def _param_counts(model):
    """(parameters, bytes) in all, and those of the bf16 weights alone."""
    params = list(model.parameters())
    bf16 = [p for p in params if p.dtype.itemsize == 2]
    return (sum(p.numel() for p in params), sum(p.numel() * p.element_size() for p in params),
            sum(p.numel() for p in bf16), sum(p.numel() * p.element_size() for p in bf16))


def _block_kinds(cfg) -> list[str]:
    """The hybrid's blocks in order: whole groups of ``block_pattern``,
    then its first ``num_layers % len(block_pattern)`` as the tail."""
    groups, tail = divmod(cfg.num_layers, len(cfg.block_pattern))
    return list(cfg.block_pattern) * groups + list(cfg.block_pattern[:tail])


def _prefill_flop(cfg, s: int) -> tuple[int, int]:
    """(projection, gate and FFN flop, attention flop with every key
    scored) of an s-token prefill; a moe FFN counts its router and every
    capacity slot of every expert, as the port computes them; a hybrid
    rec block its input, gate and output projections; the encdec also
    its encoder over ``num_stub_tokens`` frames, and each decoder
    layer's cross-attention to them."""
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    hd = cfg.num_heads * cfg.head_dim
    proj = 2 * s * (d * (q + 2 * kv) + q * d)
    if cfg.family == "hybrid":
        w, kinds = cfg.lru_width, _block_kinds(cfg)
        rec = 2 * s * (3 * d * w + 2 * w * (w // cfg.num_heads))
        ffn = 2 * s * 3 * d * cfg.d_ff
        n_attn = kinds.count("attn")
        return (n_attn * proj + (len(kinds) - n_attn) * rec + len(kinds) * ffn,
                4 * s * s * hd * n_attn)
    if cfg.family == "encdec":
        t, layers = cfg.num_stub_tokens, cfg.dec_layers
        # decoder tokens: self q, k, v, o, cross q, o and the MLP; frames:
        # each decoder layer's cross k, v and the encoder layers
        gemm = (2 * s * layers * (6 * d * d + 2 * d * cfg.d_ff)
                + 2 * t * layers * 2 * d * d
                + 2 * t * cfg.enc_layers * (4 * d * d + 2 * d * cfg.d_ff))
        return gemm, (4 * s * s + 4 * s * t) * hd * layers + 4 * t * t * hd * cfg.enc_layers
    if cfg.family == "moe":
        from repro_torch.models.moe import capacity

        ffn = 2 * d * cfg.num_experts * (s + 3 * capacity(cfg, s) * cfg.d_ff)
    else:
        ffn = 2 * s * (2 if cfg.act == "gelu" else 3) * d * cfg.d_ff
    return cfg.num_layers * (proj + ffn), 4 * s * s * hd * cfg.num_layers


def full_width_serve(np, torch, seed: int, arch: str, phase: str) -> int:
    """Phase 9(b): starcoder2-15b at full width and full depth on the
    card, bf16 weights drawn from ``seed``: a warm-up and a profiled
    2,048-token prefill, the 32,768-token prefill of
    ``SHAPES["prefill_32k"]`` with its batch cut from 32 to 1 (wall,
    tokens/s, peak memory), then the reference launcher's default serve
    and a short profiled window of it. Logits finite, every cache leaf
    of the shape and dtype ``cache_shape`` gives, every request finished
    with every token in the vocabulary. Phase 10(b) runs the same on
    olmoe-1b-7b, 11(b) on recurrentgemma-9b (its prefill launching K8
    once per rec block; then 16 teacher-forced decode steps from the
    32k prefill's cache, positions 32,768-32,783, where its 2,048-slot
    window ring wraps to slots 0-15) and 11(c) on seamless-m4t-large-v2
    (each prefill with ``num_stub_tokens`` = 1,024 encoder frames drawn
    from ``seed``; its serve decodes against the zero memory of
    ``init_cache``, as the reference's launcher does). Returns K8's
    launches over the 32k prefill."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import SINGLE
    from repro_torch.models.stack import tree_paths
    from repro_torch.serve.serve_step import make_prefill_step

    cfg = get_config(arch)
    api = get_model(cfg)
    t0 = time.perf_counter()
    model = api.init(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    n_params, n_bytes, w_params, w_bytes = _param_counts(model)
    if cfg.family == "hybrid":
        layout = (f"{cfg.num_layers} layers of {cfg.block_pattern}, lru_width "
                  f"{cfg.lru_width}")
    elif cfg.family == "encdec":
        layout = (f"{cfg.enc_layers} encoder + {cfg.dec_layers} decoder layers, "
                  f"{cfg.num_stub_tokens} encoder frames")
    elif cfg.family == "moe":
        layout = (f"{cfg.num_layers} layers, {cfg.num_experts} experts, top "
                  f"{cfg.experts_per_token}")
    else:
        layout = f"{cfg.num_layers} layers"
    log(f"phase {phase} {cfg.name}: {layout}, d_model {cfg.d_model}, {cfg.num_heads} q / "
        f"{cfg.num_kv_heads} kv heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, window {cfg.sliding_window}: {n_params} parameters, {n_bytes} "
        f"bytes ({w_params} bf16 weights, {w_bytes} bytes; the rest f32 biases, norms, "
        f"routers and gates), drawn on the card in {time.perf_counter() - t0:.3f} s; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    rng = np.random.default_rng(seed)

    def batch_of(tokens):
        batch = {"tokens": tokens}
        if cfg.family == "encdec":
            frames = rng.standard_normal((tokens.shape[0], cfg.num_stub_tokens, cfg.d_model),
                                         dtype=np.float32)
            batch["src_embed"] = torch.from_numpy(frames).to("cuda", torch.bfloat16)
        return batch

    cell = SHAPES["prefill_32k"]
    s = cell.seq_len
    # the hybrid's window cache takes cache_len >= its window; the others
    # keep the prompt's length with cache_len 0
    prefill = make_prefill_step(cfg, api, SINGLE, s if cfg.family == "hybrid" else 0)
    short = batch_of(rng.integers(0, cfg.vocab_size, (1, 2048), dtype=np.int32))
    prefill(model, short)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(model, short)
        torch.cuda.synchronize()
        short_s = time.perf_counter() - t0
    device_breakdown(prof, f"phase {phase} prefill[2048 tokens, profiled]", short_s, top=12)
    del prof, short

    batch = batch_of(rng.integers(0, cfg.vocab_size, (1, s), dtype=np.int32))
    torch.cuda.reset_peak_memory_stats()
    k8 = -_build.LAUNCHES["selective_scan"]  # the phase's own count runs on
    t0 = time.perf_counter()
    logits, cache = prefill(model, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    k8 += _build.LAUNCHES["selective_scan"]
    peak = torch.cuda.max_memory_allocated()
    gemm_flop, attn_flop = _prefill_flop(cfg, s)
    floor_s = max((gemm_flop + attn_flop) / BF16_FLOPS_PER_S, w_bytes / HBM_BYTES_PER_S)
    leaves = tree_paths(cache)
    want_k8 = _block_kinds(cfg).count("rec") if cfg.family == "hybrid" else 0
    frames = f", {cfg.num_stub_tokens} encoder frames" if cfg.family == "encdec" else ""
    log(f"phase {phase} prefill[{cell.name} with its batch cut from {cell.global_batch} to 1"
        f"{frames}]: {s} tokens in {prefill_s:.6f} s wall ({s / prefill_s:.3f} tokens/s); "
        f"{gemm_flop} projection, gate and FFN flop, {attn_flop} attention flop (every key "
        f"scored), least time at the bf16 peak {floor_s:.6f} s; peak memory {peak} bytes; cache "
        f"{sum(v.numel() * v.element_size() for v in leaves.values())} bytes in {len(leaves)} "
        f"leaves; K8 launches {k8} (expected {want_k8})")
    if logits.shape != (1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"phase {phase} prefill logits {tuple(logits.shape)} not finite "
                             f"or misshapen")
    got = {k: (tuple(v.shape), v.dtype) for k, v in leaves.items()}
    want = {k: (tuple(v.shape), v.dtype)
            for k, v in tree_paths(api.cache_shape(cfg, 1, s)).items()}
    if got != want:
        raise AssertionError(f"phase {phase} prefill cache {got}, expected {want}")
    if k8 != want_k8:
        raise AssertionError(f"phase {phase} prefill launched K8 {k8} times, want {want_k8}")
    if cfg.family == "hybrid":
        gold = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 16))).cuda()
        walls = []
        for i in range(16):
            t0 = time.perf_counter()
            step, cache = api.decode(model, gold[:, i : i + 1], cache, s + i, cfg, SINGLE, None)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if not bool(torch.isfinite(step).all()):
                raise AssertionError(f"phase {phase} decode step {i}: logits not finite")
        log(f"phase {phase} decode: 16 teacher-forced steps from the 32k prefill's cache "
            f"(positions {s}-{s + 15}, ring slots {s % cfg.sliding_window}-"
            f"{(s + 15) % cfg.sliding_window}): walls {[round(x, 6) for x in walls]} s, median "
            f"{statistics.median(walls):.6f} s; the weights' HBM floor "
            f"{w_bytes / HBM_BYTES_PER_S:.6f} s; logits finite")
    del logits, cache, batch, leaves
    torch.cuda.empty_cache()

    requests, batch, prompt_len, max_new, cache_len = 8, 4, 32, 16, 128
    prompts = rng.integers(0, cfg.vocab_size, (requests, prompt_len), dtype=np.int32)
    t0 = time.perf_counter()
    finished = serve_requests(api, model, cfg, prompts, batch=batch, max_new=max_new,
                              cache_len=cache_len)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    n_tokens = sum(len(r.generated) for r in finished)
    # each prompt but its last token fed through decode, then max_new
    # decode steps for each wave of `batch` requests
    calls = requests * (prompt_len - 1) + -(-requests // batch) * max_new
    log(f"phase {phase} serve[{requests} requests, batch {batch}, prompt {prompt_len}, max-new "
        f"{max_new}, cache-len {cache_len}]: served {len(finished)} requests, {n_tokens} tokens "
        f"in {serve_s:.6f} s wall ({n_tokens / serve_s:.3f} tokens/s; {calls} decode calls, "
        f"{serve_s / calls * 1e3:.3f} ms each, the weights' HBM floor "
        f"{w_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms)")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_requests(api, model, cfg, prompts[:2, :8], batch=batch, max_new=4,
                       cache_len=cache_len)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device_breakdown(prof, f"phase {phase} serve window[2 requests, batch {batch}, prompt 8, "
                           f"max-new 4, profiled]", window_s, top=12)
    del prof
    bad = [r.rid for r in finished
           if len(r.generated) != max_new or not all(0 <= t < cfg.vocab_size for t in r.generated)]
    if len(finished) != requests or bad:
        raise AssertionError(f"phase {phase} serve: {len(finished)} of {requests} finished; "
                             f"bad {bad}")
    log(f"phase {phase} serve: first requests {[(r.rid, r.generated[:8]) for r in finished[:4]]}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return k8


def dense_paths(np, torch, seed: int) -> None:
    """Phase 9: the dense and vlm families on the card. No hand-written
    kernel is on their path: the launch counts stay 0."""
    from repro_torch.kernels import _build

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"phase 9 starts with {torch.cuda.memory_allocated()} bytes allocated "
        f"(max_memory_allocated after a reset {torch.cuda.max_memory_allocated()})")
    _build.reset_launches()
    t0 = time.perf_counter()
    reduced_agrees(np, torch, seed)
    log(f"phase 9(a) done in {time.perf_counter() - t0:.1f} s")
    full_width_serve(np, torch, seed, "starcoder2_15b", "9(b)")
    log(f"phase 9(b) done in {time.perf_counter() - t0:.1f} s")
    launched = {name: n for name, n in _build.LAUNCHES.items() if n}
    log(f"phase 9 kernel launches: {launched or 'none'}")
    if launched:
        raise AssertionError(f"phase 9 launched kernels {launched}")


MOE_IDS = ("olmoe_1b_7b", "granite_moe_3b_a800m")


def moe_paths(np, torch, seed: int) -> None:
    """Phase 10: the moe family on the card (TF32 off). (a) Both moe ids
    at ``reduced()`` card vs CPU, as phase 9(a) holds the dense ones; (b)
    olmoe-1b-7b at full width and depth, as phase 9(b) serves
    starcoder2. The moe FFN is plain torch (as the reference's is plain
    ``jnp``): the launch counts stay 0."""
    from repro_torch.kernels import _build

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"phase 10 starts with {torch.cuda.memory_allocated()} bytes allocated")
    _build.reset_launches()
    t0 = time.perf_counter()
    reduced_agrees(np, torch, seed, MOE_IDS, "10(a)")
    log(f"phase 10(a) done in {time.perf_counter() - t0:.1f} s")
    full_width_serve(np, torch, seed, "olmoe_1b_7b", "10(b)")
    log(f"phase 10(b) done in {time.perf_counter() - t0:.1f} s")
    launched = {name: n for name, n in _build.LAUNCHES.items() if n}
    log(f"phase 10 kernel launches: {launched or 'none'}")
    if launched:
        raise AssertionError(f"phase 10 launched kernels {launched}")


HYBRID_ID, ENCDEC_ID = "recurrentgemma_9b", "seamless_m4t_large_v2"
# K8 on the RG-LRU scan, (B, S, lru_width, N = 1): recurrentgemma-9b's
# profiled 2k prefill, and its 32k prefill cell at batch 1
HYBRID_SCAN = (1, 2048, 4096, 1)
HYBRID_SCAN_32K = (1, 32768, 4096, 1)


def hybrid_k8_route(np, torch, seed: int) -> dict:
    """Phase 11(a): K8 on the RG-LRU scan at ``HYBRID_SCAN`` from h0,
    recurrentgemma-9b's gate weights drawn from ``seed`` in float32: the
    kernel's y and h_last against its plain version on the same operands
    (da = a, dbu = b, cm = 1; y within 2e-5, h_last bit-equal); then
    ``rglru_scan`` without grad (one K8 launch) against its
    associative-scan route under grad (no launch) within 2e-5. Then K8
    against its plain version over the ring body's sweep (RING_B x RING_S
    x RING_D x RING_N) and once at ``HYBRID_SCAN_32K``, and its times at
    both shapes (``scan_times``: warm, cold, plain, bound; the 32k plain
    time is that one call's). Returns the record for the kernels' JSON
    line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain
    from repro_torch.models import rglru

    cfg = get_config(HYBRID_ID)
    b, s, w, _ = HYBRID_SCAN
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = rglru.RgLru(cfg, gen, torch.float32, "cuda")
    x = torch.randn((b, s, w), generator=gen, device="cuda")
    h0 = torch.randn((b, w), generator=gen, device="cuda")
    with torch.no_grad():
        log_a, gated = rglru._gates(x, p, cfg)
        a = torch.exp(log_a).reshape(b, s, w, 1)
        bt = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gated
        bt = bt.reshape(b, s, w, 1)
    ones = torch.ones((b, s, 1), device="cuda")
    _build.reset_launches()
    y, h = selective_scan(a, bt, ones, h0=h0[..., None], return_state=True)
    want_y, want_h = selective_scan_plain(a, bt, ones, h0[..., None])
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want_y, **SCAN_TOL)
    if not torch.equal(h, want_h):
        raise AssertionError(f"phase 11(a) K8 at {HYBRID_SCAN}: h_last not bit-equal to plain "
                             f"(max_abs_err {float((h - want_h).abs().max())})")
    plain_err = float((y - want_y).abs().max())
    del y, h, want_y, want_h, a, bt, ones, log_a, gated
    _build.reset_launches()
    with torch.no_grad():
        ky, kh = rglru.rglru_scan(x, p, cfg, h0)
    k8 = _build.LAUNCHES["selective_scan"]
    gy, gh = rglru.rglru_scan(x.clone().requires_grad_(True), p, cfg, h0)
    if k8 != 1 or _build.LAUNCHES["selective_scan"] != 1 or not gy.requires_grad:
        raise AssertionError(f"phase 11(a): rglru_scan launched K8 {k8} times without grad and "
                             f"{_build.LAUNCHES['selective_scan'] - k8} under it (want 1, 0)")
    torch.testing.assert_close(ky, gy.detach(), **SCAN_TOL)
    torch.testing.assert_close(kh, gh.detach(), **SCAN_TOL)
    route_err = max(float((ky - gy.detach()).abs().max()), float((kh - gh.detach()).abs().max()))
    del ky, kh, gy, gh, x, h0, p
    torch.cuda.empty_cache()
    log(f"phase 11(a) K8 on the RG-LRU scan at {HYBRID_SCAN} with h0: y max_abs_err {plain_err} "
        f"against the plain version (tolerance 2e-5), h_last bit-equal; rglru_scan's K8 route "
        f"against its associative-scan route (under grad, K8 not launched) max_abs_err "
        f"{route_err} (tolerance 2e-5)")
    ring = scan_sweep_agrees(torch, seed, RING_B, RING_S, RING_D, RING_N)
    big_err, big_plain_ms = scan_held_once(torch, HYBRID_SCAN_32K, seed)
    log(f"phase 11(a) K8 at {HYBRID_SCAN_32K} with h0: y max_abs_err {big_err} against the "
        f"plain version (tolerance 2e-5), h_last bit-equal; plain {big_plain_ms:.3f} ms")
    rec = scan_times(torch, HYBRID_SCAN, seed)
    rec["prefill_32k"] = scan_times(torch, HYBRID_SCAN_32K, seed, plain_ms=big_plain_ms)
    rec["prefill_32k"]["max_abs_err"] = big_err
    rec["max_abs_err"] = plain_err
    rec["route_max_abs_err"] = route_err
    rec["ring_sweep"] = ring
    return rec


def hybrid_encdec_paths(np, torch, seed: int, families=("hybrid", "encdec")) -> dict:
    """Phase 11: the hybrid and encdec families on the card (TF32 off).
    (a) Each id at ``reduced()`` card vs CPU as phase 9(a) holds the
    dense ones (the hybrid's prefill launching K8 on the card, one launch
    per rec block), one ``make_train_step`` each as phase 8(a) runs them
    (no kernel: the RG-LRU trains through the associative scan), and K8
    on the RG-LRU scan (``hybrid_k8_route``); (b) recurrentgemma-9b and
    (c) seamless-m4t-large-v2 at full width and depth
    (``full_width_serve``), and seamless's ``Trainer.run`` for 6 steps
    (``train_dense_full_width``). The encdec path launches no kernel.
    Returns K8's record at the hybrid's shapes and its launches over
    11(b)'s 32k prefill."""
    from repro_torch.kernels import _build

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"phase 11 starts with {torch.cuda.memory_allocated()} bytes allocated")
    t0 = time.perf_counter()
    out = {}
    if "hybrid" in families:
        _build.reset_launches()
        reduced_agrees(np, torch, seed, (HYBRID_ID,), "11(a)")
        k8 = _build.LAUNCHES["selective_scan"]
        log(f"phase 11(a) {HYBRID_ID}: K8 launches on the card's prefills {k8}")
        if k8 <= 0:
            raise AssertionError("phase 11(a): the hybrid's prefill never launched K8")
        # one group and a rec tail. AdamW's first step scales each element's
        # gradient by 1 / (|g| + 1e-8): where |g| is near 1e-8 (1.9e-5 on
        # the card, one such element), the devices' last-bit differences
        # move it by a fraction of lr, and a bound that admits them admits
        # any step. The step is held by the gradients (1e-3 of each
        # leaf's max) and by the card's AdamW on them (1e-5), not here.
        train_step_card_vs_cpu(np, torch, seed, HYBRID_ID, "11(a)", layers=4, param_tol=None)
        out["k8"] = hybrid_k8_route(np, torch, seed)
    if "encdec" in families:
        _build.reset_launches()
        reduced_agrees(np, torch, seed, (ENCDEC_ID,), "11(a)")
        train_step_card_vs_cpu(np, torch, seed, ENCDEC_ID, "11(a)")
        launched = {name: n for name, n in _build.LAUNCHES.items() if n}
        if launched:
            raise AssertionError(f"phase 11(a) encdec launched kernels {launched}")
    log(f"phase 11(a) done in {time.perf_counter() - t0:.1f} s")
    if "hybrid" in families:
        out["launches"] = full_width_serve(np, torch, seed, HYBRID_ID, "11(b)")
        log(f"phase 11(b) done in {time.perf_counter() - t0:.1f} s")
    if "encdec" in families:
        _build.reset_launches()
        full_width_serve(np, torch, seed, ENCDEC_ID, "11(c)")
        train_dense_full_width(np, torch, seed, ENCDEC_ID, "11(c)")
        launched = {name: n for name, n in _build.LAUNCHES.items() if n}
        if launched:
            raise AssertionError(f"phase 11(c) launched kernels {launched}")
        log(f"phase 11(c) done in {time.perf_counter() - t0:.1f} s")
    return out


def mesh_train_full_width(np, torch, seed: int, mesh, wall_8b: float | None,
                          quantize: bool = False, plain: dict | None = None) -> dict:
    """Phase 12(a): falcon-mamba-7b at full width, cut to 2 layers as in
    8(b), by ``Trainer(mesh=...)`` on the one-rank NCCL mesh (1, 1): the
    state laid out as DTensors by ``state_specs``, each step under
    ``mesh_context``. Two steps with the CORE save at step 2 (rank 0
    stores the gathered state), two nodes of group 0 failed,
    ``restore_latest`` bit-equal to the state in memory, one step resumed
    from the restored state by the step function (no second save). The
    losses and the step-3 state are held against the unsharded
    ``Trainer``'s steps on the card from the same seed (bit-equal, else
    within 1e-5). One sharded step under the
    profiler gives the busy share. K8 is never launched.

    With ``quantize``, phase 12(d): the same with
    ``OptConfig(quantize_v=True)``, the int8 second moment's (q, scale)
    leaves replicated DTensors, held against the unsharded quantize_v
    ``Trainer`` (bit-equal, else the floats within 1e-5 and q within 1);
    its step walls and peak memory are logged beside ``plain``'s, 12(a)'s
    record. Returns {"walls", "peak"}."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import partition
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import convert
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.loop import LoopConfig, Trainer, _gathered

    cfg = dataclasses.replace(get_config("falcon_mamba_7b"), num_layers=2)
    steps = 3
    lc = LoopConfig(steps=steps, ckpt_every=2, log_every=1, seq_len=256, global_batch=8,
                    seed=seed, num_nodes=100)
    oc = opt.OptConfig(lr=3e-4, warmup_steps=1, decay_steps=steps, quantize_v=quantize)
    tag = "12(d)" if quantize else "12(a)"

    def flat(st):
        tree = ts.TrainState(convert.stacked_tree(st.params), st.opt, st.step)
        return [_gathered(x) for x in partition.flatten(tree)[0]]

    # the unsharded reference: the same steps, no save
    ref = Trainer(cfg, lc, oc, device="cuda")
    state = ref.init_state()
    ref_losses = []
    for step in range(steps):
        state, metrics = ref.step_fn(state, ref.pipeline.device_batch(step, ref.dev))
        ref_losses.append(float(metrics["loss"]))
    want = flat(state)
    del state, ref
    gc.collect()
    torch.cuda.empty_cache()

    tr = Trainer(cfg, lc, oc, mesh=mesh, device="cuda")
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = tr.run(until=2)
    run_s = time.perf_counter() - t0
    man = tr.ckpt.manifests[2]
    placed = sum(type(p).__name__ == "DTensor" for p in state.params.parameters())
    log(f"phase {tag} falcon-mamba-7b {cfg.num_layers} layers on the {tuple(mesh.mesh.shape)} "
        f"{mesh.device_type} mesh {mesh.mesh_dim_names}: {placed} DTensor parameters; "
        f"Trainer.run to step 2 {run_s:.3f} s with the save ({man.total_bytes} bytes, "
        f"save wall {man.save_seconds:.6f} s)")
    saved = flat(state)
    store = tr.store
    gid = man.group_ids[0]
    victims = [store.node_of((gid, 0, 0)), store.node_of((gid, 1, 3))]
    store.fail_nodes(victims)
    t0 = time.perf_counter()
    restored = tr.restore_latest()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    back = flat(restored)
    equal = len(back) == len(saved) and all(_bits_equal(torch, a, b) for a, b in zip(saved, back))
    log(f"phase {tag} restore_latest with nodes {victims} down: wall {restore_s:.6f} s, "
        f"{tr.last_restore_report.blocks_fetched} blocks fetched; {len(saved)} leaves "
        f"bit-equal {equal}")
    if not equal:
        raise AssertionError(f"phase {tag}: the restored state differs from the saved one")
    del saved, back, state
    # step 3 from the restored state, by the step function (Trainer.run
    # would save again at the end of its run)
    batch = tr.pipeline.device_batch(2, tr.dev, mesh, tr.ax)
    t0 = time.perf_counter()
    with mesh_context(mesh):
        restored, metrics = tr.step_fn(restored, batch)
    tr.metrics_log.append({"step": steps, "loss": float(metrics["loss"]),
                           "sec": time.perf_counter() - t0,
                           "grad_norm": float(metrics["grad_norm"])})
    peak = torch.cuda.max_memory_allocated()
    losses = [rec["loss"] for rec in tr.metrics_log]
    walls = [rec["sec"] for rec in tr.metrics_log]
    got = flat(restored)
    bit_equal = all(_bits_equal(torch, a, b) for a, b in zip(got, want))
    # the floats' largest difference; the int8 q's, in steps of its scale
    worst, q_worst = 0.0, 0
    for a, b in zip(got, want):
        diff = (a.float() - b.float()).abs().max()
        if a.dtype == torch.int8:
            q_worst = max(q_worst, int(diff))
        else:
            worst = max(worst, float(diff))
    loss_rel = max(abs(a / b - 1) for a, b in zip(losses, ref_losses))
    for rec in tr.metrics_log:
        log(f"phase {tag} step {rec['step']}: wall {rec['sec']:.6f} s, loss {rec['loss']:.6f}, "
            f"grad norm {rec['grad_norm']:.6f}")
    beside = (f"8(b)'s median {wall_8b:.6f} s in this run" if wall_8b is not None
              else "8(b) not run in this call")
    if plain is not None:
        beside += f"; 12(a)'s {plain['walls']}, its max_memory_allocated {plain['peak']} bytes"
    log(f"phase {tag} step walls {walls} ({beside}); max_memory_allocated {peak} bytes; losses {losses} vs unsharded "
        f"{ref_losses} (max relative {loss_rel}); step-3 state vs unsharded: bit-equal "
        f"{bit_equal}, max |diff| {worst} over {len(got)} leaves"
        + (f", int8 q max |diff| {q_worst}" if quantize else ""))
    if (len(losses) != steps or loss_rel > 1e-5 or worst > 1e-5 or q_worst > 1
            or len(got) != len(want)):
        raise AssertionError(f"phase {tag}: the sharded Trainer differs from the unsharded one")
    batch = tr.pipeline.device_batch(steps, tr.dev, mesh, tr.ax)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with mesh_context(mesh):
            restored, metrics = tr.step_fn(restored, batch)
        float(metrics["loss"])
        prof_s = time.perf_counter() - t0
    device_breakdown(prof, f"phase {tag} sharded train step 4 (profiled)", prof_s)
    k8 = _build.LAUNCHES["selective_scan"]
    log(f"phase {tag} K8 launches {k8}")
    if k8:
        raise AssertionError(f"phase {tag}: training launched K8 {k8} times")
    del restored, tr, prof
    gc.collect()
    torch.cuda.empty_cache()
    return {"walls": walls, "peak": peak}


def mesh_decode(np, torch, seed: int, mesh) -> None:
    """Phase 12(b): ``attention_decode_general``'s sequence-sharded branch
    (the flash combine) on the one-rank mesh against its unsharded branch
    on the card, reduced qwen2 in f32: T = 128 slots, the ring wrapped
    (pos 150) and not (pos 40), ``sliding_window`` 64 and none, B = 1
    with the sequence on both mesh axes and B = 2 with the batch on data
    and the sequence on model; out, k and v within 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import shardings as S

    worst = 0.0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for window in (None, 64):
        cfg = get_config("qwen2_72b").reduced(sliding_window=window)
        attn = L.init_attn(gen, cfg, torch.float32, "cuda")
        for b, plan in ((1, S.ServePlan(seq_axes=("data", "model"))),
                        (2, S.ServePlan(batch_axes=("data",), seq_axes=("model",)))):
            for pos in (40, 150):
                shape = (b, 128, cfg.num_kv_heads, cfg.head_dim)
                x1 = torch.randn((b, 1, cfg.d_model), generator=gen, device="cuda")
                ck = torch.randn(shape, generator=gen, device="cuda")
                cv = torch.randn(shape, generator=gen, device="cuda")
                want = L.attention_decode_general(x1, ck, cv, attn, cfg, S.SINGLE, pos,
                                                  S.ServePlan())
                spec = S.P(plan.batch_axes, plan.seq_axes, None, None)
                o, nk, nv = L.attention_decode_general(
                    x1, S.distribute(ck, spec, mesh), S.distribute(cv, spec, mesh), attn, cfg,
                    S.SINGLE, pos, plan)
                errs = [float((g - w).abs().max())
                        for g, w in zip((o, nk.full_tensor(), nv.full_tensor()), want)]
                worst = max(worst, *errs)
                if max(errs) > 1e-5:
                    raise AssertionError(f"phase 12(b) window {window} B {b} pos {pos}: "
                                         f"max |diff| out, k, v {errs}")
    log(f"phase 12(b) sequence-sharded decode vs unsharded on the card: 8 cases, max |diff| "
        f"{worst} (tolerance 1e-5)")


def mesh_paths(np, torch, seed: int, wall_8b: float | None = None) -> int:
    """Phase 12: a one-rank NCCL mesh (1, 1) on cuda:0 through a file
    rendezvous; 12(a), 12(b), 12(c) and 12(d) on it; then the process
    group is destroyed. The card machine has one H100, and NCCL takes one rank per
    card: the collectives run in the CPU tests (4 and 8 gloo ranks); this
    phase proves the DTensor path through the card. The XOR butterfly is
    not run: on one rank it has no round. Returns K8's launches (12(c))."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks, make_mesh

    with tempfile.TemporaryDirectory(prefix="chip-smoke-rdv-") as tmp:
        init_ranks(0, 1, "file://" + str(pathlib.Path(tmp) / "rendezvous"), "cuda", 300)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
            t0 = time.perf_counter()
            plain = mesh_train_full_width(np, torch, seed, mesh, wall_8b)
            log(f"phase 12(a) done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            mesh_decode(np, torch, seed, mesh)
            log(f"phase 12(b) done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            k8 = mesh_serve(np, torch, seed, mesh)
            log(f"phase 12(c) done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            mesh_train_full_width(np, torch, seed, mesh, wall_8b, quantize=True, plain=plain)
            log(f"phase 12(d) done in {time.perf_counter() - t0:.1f} s")
        finally:
            dist.destroy_process_group()
    return k8


def mesh_serve(np, torch, seed: int, mesh) -> int:
    """Phase 12(c): serving and the moe step on the one-rank mesh.
    falcon-mamba-7b (K8 on each rank's shard through ``local_map``) and
    olmoe-1b-7b (the moe dispatch per batch shard) at full width, cut to
    2 layers as in 12(a), in f32 on the card, the parameters as DTensors:
    the prefill of 1 x 128 tokens (one ``scan_chunk``: K8 at (1, 128,
    8192, 16), the shape of the kernels line's K8 row) and two greedy
    decodes against the same model unsharded, logits within 1e-5 of max
    |ref|; olmoe's loss and gradients on the mesh against the unsharded
    ones (1e-5 relative, 1e-4 of each leaf's max |ref|). Returns K8's
    launches on the mesh."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticPipeline, batch_specs
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import convert
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import (SINGLE, P, ServePlan, axes_for_mesh, distribute,
                                              make_serve_plan)

    ax = axes_for_mesh(mesh)
    k8 = 0
    for arch in ("falcon_mamba_7b", "olmoe_1b_7b"):
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        api = get_model(cfg)
        b, s, cache_len = 1, cfg.scan_chunk, cfg.scan_chunk + 32
        batch = SyntheticPipeline(cfg, s, b, seed).device_batch(0, "cuda")
        batch.pop("labels")
        ref_model = api.init(cfg, seed, device="cuda", dtype=torch.float32)
        model = api.init(cfg, seed, device="cuda", dtype=torch.float32)
        convert.distribute_params(model, api.specs(cfg, ax), mesh)
        plan = make_serve_plan(cfg, ax, b, cache_len)
        specs = batch_specs(cfg, ax)
        logits, cache = api.prefill(ref_model, batch, cfg, SINGLE, cache_len)
        want = [logits]
        toks = []
        for step in range(2):
            tok = torch.argmax(want[-1], dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
            logits, cache = api.decode(ref_model, tok, cache, s + step, cfg, SINGLE, ServePlan())
            want.append(logits)
        _build.reset_launches()
        with mesh_context(mesh):
            logits, cache = api.prefill(model, {k: distribute(v, specs[k], mesh)
                                                for k, v in batch.items()}, cfg, ax, cache_len)
            got = [logits]
            for step, tok in enumerate(toks):
                tok = distribute(tok, P(plan.batch_axes or None, None), mesh)
                logits, cache = api.decode(model, tok, cache, s + step, cfg, ax, plan)
                got.append(logits)
        k8 += _build.LAUNCHES["selective_scan"]
        errs = [float((g.full_tensor() - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
        log(f"phase 12(c) {arch} prefill + 2 decodes on the mesh vs unsharded (f32): relative "
            f"max |diff| {errs}; K8 launches {_build.LAUNCHES['selective_scan']}")
        if max(errs) > 1e-5 or not all(bool(torch.isfinite(w).all()) for w in want):
            raise AssertionError(f"phase 12(c) {arch}: sharded serving differs: {errs}")
        if cfg.family == "moe":
            tb = SyntheticPipeline(cfg, s, b, seed).device_batch(0, "cuda")
            ref_model.requires_grad_(True)
            model.requires_grad_(True)
            ref_loss = api.loss(ref_model, tb, cfg, SINGLE)
            ref_grads = torch.autograd.grad(ref_loss, list(ref_model.parameters()))
            with mesh_context(mesh):
                loss = api.loss(model, {k: distribute(v, specs[k], mesh) for k, v in tb.items()},
                                cfg, ax)
                grads = torch.autograd.grad(loss, list(model.parameters()))
            loss_rel = abs(float(loss.detach().full_tensor()) / float(ref_loss.detach()) - 1)
            grad_rel = max(float((g.full_tensor() - r).abs().max() / r.abs().max().clamp(min=1e-30))
                           for g, r in zip(grads, ref_grads))
            log(f"phase 12(c) {arch} loss and gradients on the mesh vs unsharded: loss relative "
                f"{loss_rel}, gradients {grad_rel} of each leaf's max")
            if loss_rel > 1e-5 or grad_rel > 1e-4:
                raise AssertionError(f"phase 12(c) {arch}: the sharded moe step differs")
        del model, ref_model, cache
    if not k8:
        raise AssertionError("phase 12(c): K8 never launched on the mesh")
    return k8


# phase 13(a): cells of the dry run on a fake world of 32 nodes x 8
# cards, (arch, shape, layers (0: all)); falcon-mamba's train_4k traces
# 1.87 M ops at its 64 layers (about 100 s on the card machine's core,
# PERF.md), so the smoke traces 16 of them
DRYRUN_MESH = "32x8"
DRYRUN_CELLS = (("falcon_mamba_7b", "train_4k", 16), ("falcon_mamba_7b", "prefill_32k", 0),
                ("falcon_mamba_7b", "decode_32k", 0), ("olmoe_1b_7b", "train_4k", 0),
                ("starcoder2_15b", "decode_32k", 0))
# phase 13(b): the cells phases 8(b) and 6(c) run for real, at a world
# of 1: (arch, sequence, batch, kind, layers (0: all))
DRYRUN_REAL = {"train_8x256": ("falcon_mamba_7b", 256, 8, "train", 2),
               "prefill_32k_b1": ("falcon_mamba_7b", 32768, 1, "prefill", 0)}
# one cell of the dry run in a process of its own: arch, cell (name,
# sequence, batch, kind), layers (0: all), the mesh ("1": a world of 1,
# no mesh; else a fake world of the mesh's size), the record's path
_CELL = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
arch, name, seq, batch, kind, layers, mesh_arg, out = sys.argv[1:]
cfg = get_config(arch)
if int(layers):
    cfg = dataclasses.replace(cfg, num_layers=int(layers))
mesh, mesh_name = None, "1"
if mesh_arg != "1":
    dryrun._fake_world(dryrun._mesh_size(mesh_arg, False))
    mesh, mesh_name = dryrun._mesh_from_arg(mesh_arg, False, device="cuda")
rec = dryrun.run_cell(arch, ShapeCell(name, int(seq), int(batch), kind), mesh, mesh_name, None,
                      cfg=cfg)
with open(out, "w") as f:
    json.dump(rec, f, default=str)
"""


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dryrun_real_steps(np, torch, seed: int) -> dict:
    """Phase 13(b)'s real steps on the card: 8(b)'s train step (falcon-
    mamba-7b at 2 layers, batch 8 x seq 256, one step of ``Trainer``'s
    step function from a fresh state) and 6(c)'s prefill (full depth, 1 x
    32,768 tokens), each from ``reset_peak_memory_stats``: the argument
    bytes, ``max_memory_allocated`` and ``max_memory_reserved``; then the
    card's memory: ``total_memory``, what lies outside the caching
    allocator (the CUDA context and libraries: total - free - reserved)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import SINGLE
    from repro_torch.models.stack import tree_leaves
    from repro_torch.serve.serve_step import make_prefill_step
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import LoopConfig, Trainer

    out = {}
    full = get_config("falcon_mamba_7b")
    lc = LoopConfig(steps=1, ckpt_every=1, seq_len=256, global_batch=8, seed=seed)
    tr = Trainer(dataclasses.replace(full, num_layers=2), lc, opt.OptConfig(), device="cuda")
    state = tr.init_state()
    batch = tr.pipeline.device_batch(0, tr.dev)
    arg = (_tensor_bytes(state.params.parameters()) + _tensor_bytes(tree_leaves(state.opt))
           + _tensor_bytes([state.step]) + _tensor_bytes(batch.values()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = tr.step_fn(state, batch)
    loss = float(metrics["loss"])
    out["train_8x256"] = {"arg_bytes": arg, "peak": torch.cuda.max_memory_allocated(),
                          "reserved": torch.cuda.max_memory_reserved(), "loss": loss}
    del state, batch, metrics, tr
    gc.collect()
    torch.cuda.empty_cache()

    api = get_model(full)
    model = api.init(full, seed, device="cuda")
    tokens = np.random.default_rng(seed).integers(0, full.vocab_size, (1, 32768), dtype=np.int32)
    arg = _tensor_bytes(model.parameters()) + tokens.nbytes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    logits, _state = make_prefill_step(full, api, SINGLE, 0)(model, {"tokens": tokens})
    torch.cuda.synchronize()
    out["prefill_32k_b1"] = {"arg_bytes": arg, "peak": torch.cuda.max_memory_allocated(),
                             "reserved": torch.cuda.max_memory_reserved(),
                             "k8": _build.LAUNCHES["selective_scan"]}
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("phase 13(b): the real prefill's logits are not finite")
    free, total = torch.cuda.mem_get_info()
    out["card"] = {"total_memory": torch.cuda.get_device_properties(0).total_memory,
                   "outside_allocator": total - free - torch.cuda.memory_reserved()}
    del model, logits, _state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dryrun_paths(np, torch, seed: int) -> int:
    """Phase 13: the dry run (``repro_torch.launch.dryrun``). Each cell is
    a process of its own, all started together (each traces on one host
    core): (a) the ``DRYRUN_CELLS`` on a fake world of 256 ranks, a 32 x
    8 mesh (32 nodes of 8 NVLink-joined cards, tensor parallel inside a
    node), each cell's record (strategy, per-rank memory against the
    budget, the three H100 roofline terms); (b) the two cells of
    ``DRYRUN_REAL`` at a world of 1 (no mesh) while the card runs the
    same steps (``dryrun_real_steps``): the argument bytes held equal to
    the real ones, the predicted peak within 20% of
    ``max_memory_allocated``. Then the per-rank budget the card gives:
    ``total_memory`` less what lies outside the allocator and less the
    allocator's headroom (reserved - allocated at the peaks). Returns
    K8's launches on the real prefill."""
    import os

    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import HBM_BUDGET

    out = ROOT / "build" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    for old in out.glob("*.json"):
        old.unlink()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    t0 = time.perf_counter()
    procs = {}
    cells = {}
    for arch, shape, layers in DRYRUN_CELLS:
        c = SHAPES[shape]
        cells[f"{arch} x {shape} x {DRYRUN_MESH}"] = (
            arch, shape, c.seq_len, c.global_batch, c.kind, layers, DRYRUN_MESH,
            out / f"{arch}.{shape}.{DRYRUN_MESH}.json")
    for name, (arch, seq, batch, kind, layers) in DRYRUN_REAL.items():
        cells[name] = (arch, name, seq, batch, kind, layers, "1", out / f"{name}.world1.json")
    for name, argv in cells.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", _CELL, *map(str, argv)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        real = dryrun_real_steps(np, torch, seed)
        real_s = time.perf_counter() - t0
        failed = []
        for name, proc in procs.items():
            text, _ = proc.communicate(timeout=max(1.0, 240 - (time.perf_counter() - t0)))
            lines = [ln for ln in text.splitlines() if ln.startswith(("TracedMemoryStats",
                                                                     "[", "fake world"))]
            for ln in lines:
                log(f"phase 13 {name}: {ln}")
            if proc.returncode:
                log(f"phase 13 {name} failed (rc {proc.returncode}):\n{text[-3000:]}")
                failed.append(name)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise AssertionError(f"phase 13: dry-run cells failed: {failed}")
    log(f"phase 13 the real steps took {real_s:.1f} s; every cell done at "
        f"{time.perf_counter() - t0:.1f} s")
    for arch, shape, _layers in DRYRUN_CELLS:
        rec = json.loads((out / f"{arch}.{shape}.{DRYRUN_MESH}.json").read_text())
        peak = rec["peak_mem_bytes"]
        log(f"phase 13(a) {arch} x {shape} x {DRYRUN_MESH} ({rec['layers']} layers): strategy "
            f"{rec['strategy']}, "
            f"trace {rec['trace_s']} s, {rec['traced_ops']} ops; per rank: arguments "
            f"{rec['arg_bytes_per_chip']}, temp {rec['temp_bytes_per_chip']}, out "
            f"{rec['out_bytes_per_chip']}, peak {peak} bytes ({peak / rec['hbm_budget']:.3f} "
            f"of the budget); flops {rec['flops_per_chip']:.6e}, bytes "
            f"{rec['bytes_per_chip']:.6e}, wire {rec['wire_bytes_per_chip']:.6e}; t_compute "
            f"{rec['t_compute']:.6f} s, t_memory {rec['t_memory']:.6f} s, t_collective "
            f"{rec['t_collective']:.6f} s, bound {rec['bottleneck']}, mfu_bound "
            f"{rec['mfu_bound']:.4f}; collectives {rec['coll_by_kind']}")
        if not (rec["arg_bytes_per_chip"] > 0 and rec["flops_per_chip"] > 0
                and math.isfinite(rec["t_collective"])):
            raise AssertionError(f"phase 13(a) {arch} x {shape}: record {rec}")
    headroom = 0
    for name in DRYRUN_REAL:
        rec = json.loads((out / f"{name}.world1.json").read_text())
        got = real[name]
        ratio = rec["peak_mem_bytes"] / got["peak"]
        headroom = max(headroom, got["reserved"] - got["peak"])
        log(f"phase 13(b) {name}: argument bytes predicted {rec['arg_bytes_per_chip']}, real "
            f"{got['arg_bytes']}; peak predicted {rec['peak_mem_bytes']}, real "
            f"max_memory_allocated {got['peak']} (ratio {ratio:.4f}), max_memory_reserved "
            f"{got['reserved']}; trace {rec['trace_s']} s, {rec['traced_ops']} ops")
        if rec["arg_bytes_per_chip"] != got["arg_bytes"]:
            raise AssertionError(f"phase 13(b) {name}: argument bytes differ")
        if abs(ratio - 1) > 0.2:
            raise AssertionError(f"phase 13(b) {name}: the predicted peak is off by more than "
                                 f"20%")
    card = real["card"]
    budget = card["total_memory"] - card["outside_allocator"] - headroom
    log(f"phase 13 the card's budget a rank: total_memory {card['total_memory']} less "
        f"{card['outside_allocator']} outside the allocator (context, libraries) less the "
        f"allocator's headroom {headroom} = {budget} bytes (dryrun.HBM_BUDGET "
        f"{int(HBM_BUDGET)})")
    return real["prefill_32k_b1"]["k8"]


# phase 14: each torch example's main(argv) on the card, the lines its
# output must hold and how many times each (once a run the example makes:
# quickstart verifies four repairs, degraded_read three reads, the
# scenario and writes demos serve twice)
EXAMPLE_RUNS = (
    ("torch_quickstart", [], ("verified=True",), 4),
    ("torch_degraded_read", [], ("ok=True",), 3),
    ("torch_repair_scheduling", [], ("--- Step pattern", "--- Plus pattern",
                                     "--- random p=0.12 pattern"), 1),
    ("torch_train_tiny_lm", ["--steps", "30"], ("== OK", "resumed to step 60"), 1),
    ("torch_gateway_serving", [], ("served 1200/1200 requests",), 1),
    ("torch_gateway_serving", ["--tenants"], ("premium:", "batch:"), 1),
    ("torch_gateway_serving", ["--scenario"],
     ("durability        0 blocks lost, 0 unreadable, 0 still missing",), 2),
    ("torch_gateway_serving", ["--graybox"], ("; 0 wrong bytes served)",
                                              "0 blocks lost, 0 unreadable, 0 still missing"), 1),
    ("torch_gateway_serving", ["--bakeoff"], ("CORE repair traffic = 0.50x RS",), 1),
    ("torch_gateway_serving", ["--writes"], ("0 stale, 0 corrupt",
                                             "0 wrong extents, 0 unreadable"), 2),
    ("torch_gateway_serving", ["--shards", "4"], ("byte-identical",
                                                  "0 blocks lost, 0 unreadable"), 1),
    ("torch_gateway_serving", ["--trace"], ("served 1200/1200 requests",), 1),
)
# words of a line that fail a run wherever they appear
EXAMPLE_FAULTS = ("verified=False", "ok=False", "CORRUPT", "MISMATCH")


def examples_paths(torch) -> dict[str, int]:
    """Phase 14: every torch example (``examples/torch_*.py``) through its
    ``main(argv)`` on the card: the three storage examples, train_tiny_lm
    at 30 steps, the gateway example in its eight modes (``--trace`` to a
    temporary file, which ``repro_torch.obs.validate_file`` checks). Each
    output is logged with its wall and must hold its checks
    (``EXAMPLE_RUNS``, and no ``EXAMPLE_FAULTS``). The launch counts are
    set to 0 before the first example and K1-K4 must have launched; the
    gateway's autotuner shares phase 5's cache file. Returns the
    kernels' launches of the phase."""
    import contextlib
    import importlib.util
    import io
    import tempfile

    from repro_torch.kernels import _build, autotune
    from repro_torch.obs import validate_file

    autotune.set_cache_path(ROOT / "build" / "chip_smoke_autotune.json")
    _build.reset_launches()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-trace-") as tmp:
        for name, args, checks, times in EXAMPLE_RUNS:
            path = ROOT / "examples" / f"{name}.py"
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            trace = str(pathlib.Path(tmp) / "trace.json") if args == ["--trace"] else None
            argv = args + [trace] if trace else args
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out = buf.getvalue()
            label = " ".join([name, *args])
            for line in out.splitlines():
                log(f"phase 14 | {line}")
            missing = [c for c in checks if out.count(c) < times]
            faults = [w for w in EXAMPLE_FAULTS if w in out]
            if trace is not None:
                log(f"phase 14 {label}: {validate_file(trace)} chrome-trace events valid")
            log(f"phase 14 {label}: wall {wall:.6f} s")
            if missing or faults:
                raise AssertionError(f"phase 14 {label}: checks missing {missing}, "
                                     f"faults {faults}")
    launches = dict(_build.LAUNCHES)
    log(f"phase 14: {len(EXAMPLE_RUNS)} example runs in {time.perf_counter() - t_phase:.1f} s; "
        f"launches {launches}")
    # the gateway's GET and PUT windows run the tile kernels; the storage
    # and training examples' encode (CoreCodec, the CORE checkpoint) and
    # BlockFixer's XOR are plain torch on the card, as the reference's are
    # jnp, and BlockFixer's GF(256) steps launch K5 only where a repair
    # takes one, so K5 and K7 are counted but not required
    used = {"ragged_gf256_tiles", "ragged_xor_tiles", "ragged_gf256_encode_tiles",
            "ragged_xor_encode_tiles"}
    idle = sorted(k for k in used if not launches[k])
    if idle:
        raise AssertionError(f"phase 14: the examples never launched {idle}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiles-only", action="store_true",
                    help="build, then time the tile kernels K1-K4 at TILE_SHAPES, and stop "
                         "(no equality check, no other phase, no result line)")
    ap.add_argument("--scan-only", action="store_true",
                    help="build, print ptxas's report for each K8 body, run phase 6(a), the "
                         "ring body's sweep and K8's S sweeps at (B, S, 8192, 16) and (B, S, "
                         "4096, 1), time the ring body at 2 and 4 stages, and stop (no "
                         "other phase, no result line)")
    ap.add_argument("--storage-only", action="store_true",
                    help="build, run phase 7 (the scenario engine and the CORE checkpoint "
                         "layer on the card), and stop (no other phase, no result line)")
    ap.add_argument("--train-only", action="store_true",
                    help="build, run phase 8 (the training path on the card), and stop "
                         "(no other phase, no result line)")
    ap.add_argument("--dense-only", action="store_true",
                    help="build, run phase 9 (the dense and vlm families on the card), and "
                         "stop (no other phase, no result line)")
    ap.add_argument("--moe-only", action="store_true",
                    help="build, run phase 10 (the moe family on the card), and stop (no "
                         "other phase, no result line)")
    ap.add_argument("--hybrid-only", action="store_true",
                    help="build, run phase 11(a) and 11(b) for the hybrid family "
                         "(recurrentgemma-9b), and stop (no other phase, no result line)")
    ap.add_argument("--encdec-only", action="store_true",
                    help="build, run phase 11(a) and 11(c) for the encdec family "
                         "(seamless-m4t-large-v2), and stop (no other phase, no result line)")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="build, run phase 13 (the dry run on a fake world, and its "
                         "prediction held against the card's real steps), and stop (no other "
                         "phase, no result line)")
    ap.add_argument("--examples-only", action="store_true",
                    help="build, run phase 14 (every torch example on the card), and stop (no "
                         "other phase, no result line)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build, run phase 12 (the one-rank NCCL mesh: sharded training and "
                         "the sequence-sharded decode), and stop (no other phase, no result "
                         "line)")
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

    t_start = time.perf_counter()
    if args.tiles_only:
        rng = np.random.default_rng(args.seed)
        entry = tile_entries()
        shapes = {name: time_tile_shapes(np, torch, rng, name, entry[name], is_gf, kk)
                  for name, _r, is_gf, kk in KERNELS}
        log(json.dumps({"tile_shapes": shapes}))
        log(smi)
        return 0
    if args.scan_only:
        for line in scan_ptxas(_build.build_log):
            log(line)
        row = check_scan_kernel(torch, args.seed)
        ring = scan_sweep_agrees(torch, args.seed, RING_B, RING_S, RING_D, RING_N)
        log(json.dumps({
            "selective_scan": row, "ring_sweep": ring,
            "s_sweep": scan_s_sweep(torch, args.seed, 8192, 16, (1, 2, 4, 8, 16, 32, 64, 128)),
            "rglru_sweep": scan_s_sweep(torch, args.seed, 4096, 1, RGLRU_S),
            "ring_stages": scan_stage_times(torch, args.seed)}))
        log(smi)
        return 0
    if args.storage_only:
        storage_paths(np, torch, args.seed)
        log(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")
        log(smi)
        return 0
    # float32 products in full float32, stated: cuDNN convolutions would
    # take TF32 by default (the port's conv is a shifted sum, not cuDNN)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.train_only:
        train_paths(np, torch, args.seed)
        log(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")
        log(smi)
        return 0
    if args.dense_only:
        dense_paths(np, torch, args.seed)
        log(f"phase 9 done at {time.perf_counter() - t_start:.1f} s")
        log(smi)
        return 0
    if args.moe_only:
        moe_paths(np, torch, args.seed)
        log(f"phase 10 done at {time.perf_counter() - t_start:.1f} s")
        log(smi)
        return 0
    if args.hybrid_only or args.encdec_only:
        hybrid_encdec_paths(np, torch, args.seed,
                            ("hybrid",) if args.hybrid_only else ("encdec",))
        log(f"phase 11 done at {time.perf_counter() - t_start:.1f} s")
        log(smi)
        return 0
    if args.mesh_only:
        mesh_paths(np, torch, args.seed)
        log(f"phase 12 done at {time.perf_counter() - t_start:.1f} s")
        log(smi)
        return 0
    if args.dryrun_only:
        dryrun_paths(np, torch, args.seed)
        log(f"phase 13 done at {time.perf_counter() - t_start:.1f} s")
        log(smi)
        return 0
    if args.examples_only:
        examples_paths(torch)
        log(f"phase 14 done at {time.perf_counter() - t_start:.1f} s")
        log(smi)
        return 0
    rows = check_kernels(np, torch, args.seed)
    matrix_rows = check_matrix_kernels(np, torch, args.seed)
    codec = codec_path(np, torch, args.seed)
    log(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")
    small_trace_agrees(np, args.seed + 9)
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    ragged = serve_ragged(np, args.seed)
    gc.collect()  # phase 4's gateway held 4.5 GiB of host blocks
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")
    bucketed = serve_bucketed(np, args.seed)
    log(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")
    scan_row = check_scan_kernel(torch, args.seed)
    reduced_model_agrees(np, torch, args.seed)
    scan_launches = full_width_model(np, torch, args.seed)
    scan_row["launches"] = scan_launches["prefill"] + scan_launches["serve"]
    log(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")
    storage = storage_paths(np, torch, args.seed)
    log(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")
    wall_8b = train_paths(np, torch, args.seed)
    log(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")
    dense_paths(np, torch, args.seed)
    log(f"phase 9 done at {time.perf_counter() - t_start:.1f} s")
    moe_paths(np, torch, args.seed)
    log(f"phase 10 done at {time.perf_counter() - t_start:.1f} s")
    hybrid = hybrid_encdec_paths(np, torch, args.seed)
    log(f"phase 11 done at {time.perf_counter() - t_start:.1f} s")
    mesh_k8 = mesh_paths(np, torch, args.seed, wall_8b)
    log(f"phase 12 done at {time.perf_counter() - t_start:.1f} s")
    dryrun_k8 = dryrun_paths(np, torch, args.seed)
    log(f"phase 13 done at {time.perf_counter() - t_start:.1f} s")
    examples = examples_paths(torch)
    log(f"phase 14 done at {time.perf_counter() - t_start:.1f} s")
    # K8 runs on phase 6(c)'s prefill and serve, phase 11(b)'s prefill,
    # the mesh serves of 12(c) and the real prefill of 13(b)
    scan_row["launches_by_phase"] = {"6": scan_row["launches"], "11": hybrid["launches"],
                                     "12": mesh_k8, "13": dryrun_k8}
    scan_row["launches"] = sum(scan_row["launches_by_phase"].values())
    scan_row["hybrid"] = hybrid["k8"]
    # each kernel's launches come from the paths that run it: K5 and K7 on
    # the codec path, K6 and K7 batched on phase 5's bucketed serve, and
    # every one of them on phase 14's examples
    source = {"gf256_matmul_planes": ("2", codec), "xor_parity": ("2", codec),
              "gf256_matmul_planes_batched": ("5", bucketed),
              "xor_parity_batched": ("5", bucketed)}
    for row in matrix_rows:
        phase, counts = source[row["name"]]
        row["launches_by_phase"] = {phase: counts[row["name"]], "14": examples[row["name"]]}
        row["launches"] = sum(row["launches_by_phase"].values())
    # the tile kernels run on the serves of phases 4 and 5, on the
    # scenario runs of phase 7 and on phase 14's gateway examples: their
    # count is the sum
    for row in rows:
        name = row["name"]
        row["launches_by_phase"] = {
            "4": ragged[name], "5": bucketed[name],
            "7": storage["7a"][name] + storage["7b"][name], "14": examples[name],
        }
        row["launches"] = sum(row["launches_by_phase"].values())
    log(json.dumps({"kernels": rows + matrix_rows + [scan_row]}))
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
