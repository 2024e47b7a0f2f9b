"""The training loop (src/repro/train/loop.py): pipeline -> train
step -> CORE checkpointing, with restart-from-latest, failure injection
hooks and per-step telemetry.

This is the single-process engine that the launcher (launch/train.py)
drives, on one device: the card unless ``device="cpu"`` is asked for
(``None`` raises without a card; nothing falls back to the host). The
CORE checkpoint layer is always on: ``save`` serializes the state in
the reference's layout (``models.convert.to_reference_tree``, the
stacked optimizer state and the step), so the byte stream, the group
matrices and the checksums are the reference's for the same state;
``restore_latest`` decodes it through failed nodes and rebuilds a
``TrainState`` on the device. Every family trains (ssm, dense, vlm,
moe, hybrid and encdec; the pipeline feeds the encdec's ``src_embed``).
The reference's ``mesh`` (and ``place_state``) waits for the mesh
slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.checkpoint.core_ckpt import CoreCheckpointer
from repro_torch.configs.base import ArchConfig
from repro_torch.core.product_code import CoreCode
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import convert
from repro_torch.models.registry import get_model
from repro_torch.models.shardings import SINGLE
from repro_torch.storage.blockstore import BlockStore
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts
from repro_torch.train.elastic import HostMonitor


@dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    num_nodes: int = 20  # simulated storage nodes backing checkpoints


@dataclass
class Trainer:
    cfg: ArchConfig
    lc: LoopConfig
    oc: opt.OptConfig = field(default_factory=opt.OptConfig)
    mesh: Any = None
    device: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "a mesh waits for the mesh slice (ROADMAP queue 1); the port trains on one device")
        self.dev = resolve_device(self.device)
        self.api = get_model(self.cfg)
        self.ax = SINGLE
        self.pipeline = SyntheticPipeline(
            self.cfg, self.lc.seq_len, self.lc.global_batch, self.lc.seed
        )
        code = CoreCode(self.cfg.core_code.n, self.cfg.core_code.k, self.cfg.core_code.t)
        self.store = BlockStore(num_nodes=self.lc.num_nodes)
        self.ckpt = CoreCheckpointer(self.store, code, device=str(self.dev))
        self.monitor = HostMonitor()
        self.step_fn = ts.make_train_step(self.cfg, self.api, self.ax, self.oc)
        self.metrics_log: list[dict] = []

    # -- state lifecycle ------------------------------------------------------

    def init_state(self) -> ts.TrainState:
        return ts.init_state(self.cfg, self.api, self.lc.seed, self.oc, device=self.dev)

    def save(self, state: ts.TrainState):
        """CORE-encode ``state`` as the reference's tree: stacked params
        (CPU tensors), the stacked optimizer state and the step."""
        host_state = ts.TrainState(convert.to_reference_tree(state.params),
                                   state.opt, state.step)
        return self.ckpt.save(int(state.step), host_state)

    def restore_latest(self) -> ts.TrainState | None:
        step = self.ckpt.latest_step()
        if step is None:
            return None
        tree, report = self.ckpt.restore(step)
        self.last_restore_report = report
        params = convert.from_jax(tree.params, self.cfg, device=self.dev, trainable=True)
        return ts.TrainState(params, convert.tree_to(tree.opt, self.dev),
                             tree.step.to(self.dev))

    # -- run --------------------------------------------------------------------

    def run(self, state: ts.TrainState | None = None,
            until: int | None = None,
            on_step: Callable | None = None) -> ts.TrainState:
        if state is None:
            state = self.restore_latest() or self.init_state()
        until = until if until is not None else self.lc.steps
        start = int(state.step)
        for step in range(start, until):
            batch = self.pipeline.device_batch(step, self.dev)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.monitor.beat("host0", step, dt)
            rec = {"step": step + 1, "loss": loss, "sec": dt,
                   "grad_norm": float(metrics["grad_norm"])}
            self.metrics_log.append(rec)
            if (step + 1) % self.lc.log_every == 0:
                print(f"step {step+1:5d}  loss {loss:.4f}  "
                      f"gnorm {rec['grad_norm']:.3f}  {dt*1e3:.0f} ms")
            if (step + 1) % self.lc.ckpt_every == 0 or step + 1 == until:
                man = self.save(state)
                print(f"  ckpt @ {step+1}: {len(man.group_ids)} CORE groups, "
                      f"{man.total_bytes/1e6:.1f} MB, {man.save_seconds:.2f}s")
            if on_step is not None:
                on_step(self, state, step)
        return state
