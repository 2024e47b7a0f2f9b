"""Fused selective scan (K8): the Mamba-1 recurrence and its output
contraction,

    h_t = da_t * h_{t-1} + dbu_t          (diagonal, per (d, n))
    y_t[d] = sum_n h_t[d, n] * c_t[n]

for da, dbu (B, S, D, N) f32 and cm (B, S, N) f32 -> y (B, S, D) f32,
from h_{-1} = h0 (zeros by default), optionally returning h_{S-1}.

The kernel is CUDA C++ (``csrc/selective_scan.cu``) with two bodies,
chosen by N in the C entry: ``selective_scan_kernel_vec`` (one thread
per (b, d, four values of n), float4 loads) for N >= 4, which holds the
decode step's one token and the prefill chunk, and
``selective_scan_kernel`` (one thread per (b, d, n)) for N < 4. Both
carry h in registers over the S loop, so the state never goes to device
memory. It replaces src/repro/kernels/selective_scan.py
``selective_scan``; the TPU kernel's block sizes (``bs``, ``bd``) have
no counterpart, since the CUDA kernel fixes its own launch shape. It is
bytes-bound (4 flops per 8 bytes of da and dbu). The wrapper launches it
for a CUDA tensor and runs ``selective_scan_plain`` for a CPU tensor;
the CUDA path never falls back.

K8 is forward only, as the TPU kernel is: the kernel writes through raw
pointers, so its output would carry no ``grad_fn`` and everything
upstream of it would silently get no gradient. The wrapper therefore
raises ``ValueError`` when grad mode is on and an operand requires
grad, on every device. Training runs ``models.mamba._chunk_scan``, the
reference's associative scan, instead.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.backend import raw_stream


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
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (da, dbu, cm, h0)):
        raise ValueError("selective_scan (K8) has no backward: an operand requires grad "
                         "(training runs models.mamba._chunk_scan)")
    # on the card, for N >= 4, the kernel reads da, dbu and h0 as float4
    vec = da.device.type != "cpu" and da.dim() == 4 and da.shape[-1] >= 4
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
    if da.device.type == "cpu":
        y, h_last = selective_scan_plain(da, dbu, cm, h0)
        return (y, h_last) if return_state else y
    if da.device.type != "cuda":
        raise ValueError(f"operands must lie on a CUDA device or the CPU, not {da.device}")
    b, s, d, n = da.shape
    y = da.new_empty((b, s, d))
    h_last = da.new_empty((b, d, n)) if return_state else None
    stream = raw_stream(da.device)
    _build.launch("selective_scan", da.data_ptr(), dbu.data_ptr(), cm.data_ptr(),
                  None if h0 is None else h0.data_ptr(), y.data_ptr(),
                  None if h_last is None else h_last.data_ptr(), b, s, d, n, stream)
    return (y, h_last) if return_state else y
