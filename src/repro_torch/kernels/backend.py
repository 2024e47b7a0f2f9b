"""Device resolution and host/device helpers for the port's kernel stack.

``device=None`` (or ``"cuda"``) everywhere in the port means "the card":
it resolves to ``cuda:0`` and RAISES when no CUDA device is present.
The CPU is taken only when a caller names it (``device="cpu"``), which
is what the tests do: on a CPU tensor every kernel wrapper runs its
plain torch version of the same tile algebra. There is no silent CPU
fallback anywhere.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None``/``"cuda"`` -> ``cuda:0`` (raises without CUDA); ``"cpu"``
    -> the CPU; ``"cuda:<i>"`` -> that card; ``"meta"`` -> shapes and
    dtypes only, no storage (``train_step.state_shape``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type in ("cpu", "meta"):
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (want 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the plain "
            "torch path on the host"
        )
    return torch.device("cuda", 0 if dev.index is None else dev.index)


def as_u8(x, device: str | torch.device | None = None) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a uint8 tensor. A tensor stays on
    its own device unless ``device`` names another; a numpy array goes
    to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint8 and (device is None or x.device == device):
            return x
        t = x if device is None else x.to(resolve_device(device))
    else:
        t = torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))
    return t if t.dtype == torch.uint8 else t.to(torch.uint8)


def reject_dtensor(what: str, *tensors) -> None:
    """A kernel wrapper takes plain tensors: it reads raw pointers, which a
    DTensor (one rank's shard of a global value) would silently hand it.
    Raises TypeError for a DTensor operand; the call site unwraps its
    shards through ``local_map``."""
    dtensor = sys.modules.get("torch.distributed.tensor")  # no DTensor before its import
    if dtensor is not None and any(isinstance(t, dtensor.DTensor) for t in tensors):
        raise TypeError(f"{what} takes plain tensors, not DTensors: call it on each rank's "
                        "shard (torch.distributed.tensor.experimental.local_map)")


def check_cuda_operands(width: int, what: str, *tensors: torch.Tensor) -> None:
    """What every CUDA body of kernels/csrc/ takes: operands on the card,
    contiguous, the first 16-byte aligned, and ``width`` (the bytes a
    block or tile covers, named ``what`` in errors) whole uint4 vectors.
    Raises ValueError on anything else."""
    if tensors[0].device.type != "cuda":
        raise ValueError(
            f"operands must lie on a CUDA device or the CPU, not {tensors[0].device}"
        )
    if width % 16:
        raise ValueError(f"{what} {width} is not a multiple of 16 bytes")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if tensors[0].data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned for vector loads")


def raw_stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``
    (a CUDA device with an index), read without building a
    ``torch.cuda.Stream`` object: what a kernel launch is given."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU): the port's
    counterpart of ``jax.block_until_ready`` before a clock read."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
