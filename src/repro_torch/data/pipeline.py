"""Deterministic synthetic data pipeline (src/repro/data/pipeline.py).

Stateless-resumable: ``batch_at(step)`` is a pure function of
(seed, step), so a restarted job replays the exact token stream from its
checkpointed cursor — no pipeline state needs to be saved beyond the
step counter (the cursor *is* part of the CORE-encoded checkpoint via
TrainState.step). It draws the reference's numpy stream in the
reference's order, so both packages give the same batches bit for bit.

The stream is not uniform noise: tokens follow a per-sequence 2-state
Markov chain over vocab halves, so the LM loss has learnable structure.

On a mesh the batch is laid out by ``batch_specs`` (the batch dim over
the dp axes): every rank draws the same global batch and keeps its own
rows as a DTensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.layers import TensorSpec
from repro_torch.models.shardings import P, distribute


def batch_specs(cfg: ArchConfig, ax, *, with_stub: bool = True) -> dict:
    """Specs of a train batch (batch dim over the dp axes)."""
    specs = {"tokens": P(ax.dp, None), "labels": P(ax.dp, None)}
    if with_stub and cfg.family == "vlm":
        specs["patch_embed"] = P(ax.dp, None, None)
    if with_stub and cfg.family == "encdec":
        specs["src_embed"] = P(ax.dp, None, None)
    return specs


def _bf16(x: np.ndarray) -> torch.Tensor:
    """f32 -> bfloat16, rounded to nearest even as ml_dtypes rounds."""
    return torch.from_numpy(x).to(torch.bfloat16)


@dataclass
class SyntheticPipeline:
    cfg: ArchConfig
    seq_len: int
    global_batch: int
    seed: int = 0

    def _text_len(self) -> int:
        if self.cfg.family == "vlm":
            return self.seq_len - self.cfg.num_stub_tokens
        return self.seq_len

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step) -> batch dict of host arrays:
        int32 numpy tokens and labels, and for the vlm / encdec stubs a
        bfloat16 CPU tensor (numpy has no bfloat16 without ml_dtypes)."""
        s = self._text_len()
        b = self.global_batch
        v = self.cfg.vocab_size
        rng = np.random.default_rng(np.uint64(self.seed * 1_000_003 + step))
        # 2-state Markov over vocab halves: learnable bigram structure
        state = rng.integers(0, 2, size=(b, 1))
        flips = rng.random((b, s)) < 0.15
        states = np.bitwise_xor.accumulate(
            np.concatenate([state, flips[:, 1:]], axis=1), axis=1
        )
        half = v // 2
        tok = (rng.integers(0, half, size=(b, s)) + states * half).astype(np.int32)
        batch = {
            "tokens": tok,
            "labels": np.roll(tok, -1, axis=1).astype(np.int32),
        }
        if self.cfg.family == "vlm":
            batch["patch_embed"] = _bf16(rng.standard_normal(
                (b, self.cfg.num_stub_tokens, self.cfg.d_model), np.float32
            ))
        if self.cfg.family == "encdec":
            batch["src_embed"] = _bf16(rng.standard_normal(
                (b, self.cfg.num_stub_tokens, self.cfg.d_model), np.float32
            ))
        return batch

    def device_batch(self, step: int, device=None, mesh=None, ax=None) -> dict:
        """``batch_at(step)`` as tensors on ``device`` (the card by
        default; ``"cpu"`` when asked); with ``mesh`` (and its
        ``MeshAxes`` ``ax``) as DTensors laid out by ``batch_specs``."""
        dev = resolve_device(device)
        batch = {k: (x if isinstance(x, torch.Tensor) else torch.from_numpy(x)).to(dev)
                 for k, x in self.batch_at(step).items()}
        if mesh is None:
            return batch
        specs = batch_specs(self.cfg, ax)
        return {k: distribute(x, specs[k], mesh) for k, x in batch.items()}


def shapes_for_cell(cfg: ArchConfig, cell: ShapeCell) -> dict[str, TensorSpec]:
    """Shapes and dtypes of a *train/prefill* batch of ``cell``."""
    s = cell.seq_len - (cfg.num_stub_tokens if cfg.family == "vlm" else 0)
    b = cell.global_batch
    out = {
        "tokens": TensorSpec((b, s), torch.int32),
        "labels": TensorSpec((b, s), torch.int32),
    }
    if cfg.family == "vlm":
        out["patch_embed"] = TensorSpec((b, cfg.num_stub_tokens, cfg.d_model), torch.bfloat16)
    if cfg.family == "encdec":
        out["src_embed"] = TensorSpec((b, cfg.num_stub_tokens, cfg.d_model), torch.bfloat16)
    if cell.kind != "train":
        out.pop("labels")
    return out
