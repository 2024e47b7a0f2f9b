"""Fused selective scan (K8): the Mamba-1 recurrence and its output
contraction,

    h_t = da_t * h_{t-1} + dbu_t          (diagonal, per (d, n))
    y_t[d] = sum_n h_t[d, n] * c_t[n]

for da, dbu (B, S, D, N) f32 and cm (B, S, N) f32 -> y (B, S, D) f32,
from h_{-1} = h0 (zeros by default), optionally returning h_{S-1}.

The kernel is CUDA C++ (``csrc/selective_scan.cu``) with two bodies,
chosen by ``scan_plan``: ``selective_scan_kernel_vec`` (one thread per
(b, d, four values of n), float4 loads) for N >= 4, which holds the
decode step's one token and the prefill chunk, and
``selective_scan_kernel_ring`` (one warp per 32 (d, n) columns,
streaming all of S through a ring of stages in shared memory) for
N in {1, 2}, which holds the RG-LRU scan's long, narrow (1, S, 4096, 1).
Each carries h in registers over the S loop, so the state never goes to
device memory. It replaces
src/repro/kernels/selective_scan.py ``selective_scan``; the TPU
kernel's block sizes (``bs``, ``bd``) have no counterpart: ``scan_plan``
gives the launch shape, and the C entry checks it. It is bytes-bound
(4 flops per 8 bytes of da and dbu). The wrapper launches it for a CUDA
tensor and runs ``selective_scan_plain`` for a CPU tensor; the CUDA path
never falls back.

K8 is forward only, as the TPU kernel is: the kernel writes through raw
pointers, so its output would carry no ``grad_fn`` and everything
upstream of it would silently get no gradient. The wrapper therefore
raises ``ValueError`` when grad mode is on and an operand requires
grad, on every device. Training runs ``models.mamba._chunk_scan``, the
reference's associative scan, instead.

On ``meta`` operands (the dry run, ``launch/dryrun.py``) the wrapper
returns empty outputs of the right shapes and launches nothing: the
plain version's loop over S would take hours on the host at a 32k
prefill. ``meta_hook``, when set, is called with the bytes the launch
would move (``scan_bytes``), which is how the dry run's roofline counts
K8's memory traffic.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.backend import raw_stream, reject_dtensor


# the C entry's body codes (csrc/selective_scan.cu kBody*)
BODY_VEC, BODY_RING = 0, 1
VEC_THREADS = 256  # float4 body: threads per block, 4 columns each (kVecThreads)
RING_STEPS = 16  # ring body: time steps per stage (kRingSteps)
RING_COLS = 32  # ring body: (d, n) columns per one-warp block, one a lane (kRingCols)
# ring body, bytes of one stage: da and dbu rows (RING_STEPS x RING_COLS
# floats each) and the stage's cm (32 floats) (kStageBytes)
RING_STAGE_BYTES = 4 * (2 * RING_STEPS * RING_COLS + 32)
# ring body: below this many bytes in one stage a warp, 4 stages (3
# ahead), else 2 (chip_smoke.py --scan-only's sweep and the .cu header)
RING_ONE_AHEAD_BYTES = 1_500_000


# called with scan_bytes(...) of each meta launch (the dry run's roofline)
meta_hook: Callable[[int], None] | None = None


def scan_bytes(b: int, s: int, d: int, n: int, *, h0: bool = True,
               h_last: bool = True) -> int:
    """Bytes K8 must move: da, dbu and cm read once, h0 read once when
    given; y written once, h_last written once when returned (the bound
    column of the kernel table, PERF.md)."""
    return 4 * (2 * b * s * d * n + b * s * n + b * s * d + (b * d * n) * (h0 + h_last))


class ScanPlan(NamedTuple):
    """K8's launch for one (B, S, D, N), what the C entry takes: the
    body, the ring body's stages (0 for the float4 body) and the grid
    (blocks over the columns d * N + n of one b, B). A block covers
    ``4 * VEC_THREADS`` contiguous columns (float4 body) or ``RING_COLS``
    (ring body)."""
    body: int
    stages: int
    grid: tuple[int, int]


def scan_plan(b: int, s: int, d: int, n: int) -> ScanPlan:
    """The float4 body for N >= 4. For N in {1, 2} the ring body, one
    warp a block, for every S: 4 stages while its B * ceil(D * N / 32)
    warps hold less than RING_ONE_AHEAD_BYTES one stage each (3 stages,
    48 steps of da and dbu ahead), else 2 (every warp resident, one stage
    ahead). ``s`` does not enter: the ring body's pre-issue stops at S."""
    cols = d * n
    if n >= 4:
        return ScanPlan(BODY_VEC, 0, (-(-cols // (4 * VEC_THREADS)), b))
    grid = (-(-cols // RING_COLS), b)
    stages = 4 if grid[0] * b * RING_STAGE_BYTES < RING_ONE_AHEAD_BYTES else 2
    return ScanPlan(BODY_RING, stages, grid)


def selective_scan_plain(da: torch.Tensor, dbu: torch.Tensor, cm: torch.Tensor,
                         h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: a loop over t in f32. Returns (y, h_last)."""
    b, s, d, n = da.shape
    h = torch.zeros((b, d, n), dtype=torch.float32, device=da.device) if h0 is None else h0
    ys = []
    for t in range(s):
        h = da[:, t] * h + dbu[:, t]
        ys.append((h * cm[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1), h


def _check(da, dbu, cm, h0) -> None:
    reject_dtensor("selective_scan", da, dbu, cm, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (da, dbu, cm, h0)):
        raise ValueError("selective_scan (K8) has no backward: an operand requires grad "
                         "(training runs models.mamba._chunk_scan)")
    # on the card, for N >= 4, the kernel reads da, dbu and h0 as float4
    vec = da.device.type == "cuda" and da.dim() == 4 and da.shape[-1] >= 4
    for name, t in (("da", da), ("dbu", dbu), ("cm", cm), ("h0", h0)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != da.device:
            raise ValueError(f"{name} lies on {t.device}, da on {da.device}")
        if vec and name != "cm" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the kernel's float4 loads")
    if da.dim() != 4:
        raise ValueError(f"da must be (B, S, D, N), got {tuple(da.shape)}")
    b, s, d, n = da.shape
    if 0 in da.shape:
        raise ValueError(f"empty operand {tuple(da.shape)}")
    if dbu.shape != da.shape:
        raise ValueError(f"dbu {tuple(dbu.shape)} != da {tuple(da.shape)}")
    if cm.shape != (b, s, n):
        raise ValueError(f"cm must be {(b, s, n)}, got {tuple(cm.shape)}")
    if h0 is not None and h0.shape != (b, d, n):
        raise ValueError(f"h0 must be {(b, d, n)}, got {tuple(h0.shape)}")
    if n > 32 or n & (n - 1):
        raise ValueError(f"N = {n}: the kernel takes a power of two up to 32")


def selective_scan(da: torch.Tensor, dbu: torch.Tensor, cm: torch.Tensor, *,
                   h0: torch.Tensor | None = None, return_state: bool = False):
    """K8: y (B, S, D) f32, or (y, h_last (B, D, N)) with ``return_state``.
    ``h0=None`` starts from zeros. Every operand is float32 and
    contiguous (``cm`` split out of a wider projection is a strided view:
    the caller makes it contiguous); on the card, for N >= 4, ``da``,
    ``dbu`` and ``h0`` start on a 16-byte boundary."""
    _check(da, dbu, cm, h0)
    if da.device.type == "meta":  # shapes only: no launch, no plain loop
        b, s, d, n = da.shape
        if meta_hook is not None:
            meta_hook(scan_bytes(b, s, d, n, h0=h0 is not None, h_last=return_state))
        y = da.new_empty((b, s, d))
        return (y, da.new_empty((b, d, n))) if return_state else y
    if da.device.type == "cpu":
        y, h_last = selective_scan_plain(da, dbu, cm, h0)
        return (y, h_last) if return_state else y
    if da.device.type != "cuda":
        raise ValueError(f"operands must lie on a CUDA device, the CPU or meta, not "
                         f"{da.device}")
    b, s, d, n = da.shape
    y = da.new_empty((b, s, d))
    h_last = da.new_empty((b, d, n)) if return_state else None
    plan = scan_plan(b, s, d, n)
    stream = raw_stream(da.device)
    _build.launch("selective_scan", da.data_ptr(), dbu.data_ptr(), cm.data_ptr(),
                  None if h0 is None else h0.data_ptr(), y.data_ptr(),
                  None if h_last is None else h_last.data_ptr(), b, s, d, n, plan.body,
                  plan.stages, plan.grid[0], stream)
    return (y, h_last) if return_state else y
