"""The training loop (src/repro/train/loop.py): pipeline -> train
step -> CORE checkpointing, with restart-from-latest, failure injection
hooks and per-step telemetry.

This is the engine that the launcher (launch/train.py) drives, on one
device: the card unless ``device="cpu"`` is asked for (``None`` raises
without a card; nothing falls back to the host). The CORE checkpoint
layer is always on: ``save`` serializes the state in the reference's
layout (``models.convert.to_reference_tree``, the stacked optimizer
state and the step), so the byte stream, the group matrices and the
checksums are the reference's for the same state; ``restore_latest``
decodes it through failed nodes and rebuilds a ``TrainState`` on the
device. Every family trains (ssm, dense, vlm, moe, hybrid and encdec;
the pipeline feeds the encdec's ``src_embed``).

With ``mesh`` (a ``DeviceMesh`` from launch/mesh.py) every rank runs
this engine in its own process: ``place_state`` lays each leaf of the
state out as a DTensor by ``train_step.state_specs``, each step's batch
by ``data.pipeline.batch_specs``, and the step runs under
``launch.mesh.mesh_context``. Here the port differs from the reference,
whose one process holds global arrays: on ``save`` every rank gathers
each leaf (``full_tensor``; a replicated leaf, such as the int8 second
moment's (q, scale) with ``OptConfig(quantize_v=True)``, is a local
read) and rank 0 alone encodes and stores it, so the bytes are the
reference's for the same global state; on
``restore_latest`` rank 0 decodes and the state is laid out again from
rank 0's values. The store is rank 0's; only rank 0 prints.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint.core_ckpt import CoreCheckpointer
from repro_torch.configs.base import ArchConfig
from repro_torch.core.product_code import CoreCode
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import convert
from repro_torch.models.registry import get_model
from repro_torch.models.shardings import SINGLE, axes_for_mesh, distribute, is_dtensor
from repro_torch.models.stack import tree_map
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
        self.dev = resolve_device(self.device)
        self.rank = 0
        if self.mesh is not None:
            if self.mesh.device_type != self.dev.type:
                raise ValueError(f"a {self.mesh.device_type} mesh for device {self.dev}")
            if self.dev.type == "cuda":
                self.dev = torch.device("cuda", torch.cuda.current_device())
            self.rank = dist.get_rank()
        self.api = get_model(self.cfg)
        self.ax = axes_for_mesh(self.mesh) if self.mesh is not None else SINGLE
        self.pipeline = SyntheticPipeline(
            self.cfg, self.lc.seq_len, self.lc.global_batch, self.lc.seed
        )
        code = CoreCode(self.cfg.core_code.n, self.cfg.core_code.k, self.cfg.core_code.t)
        self.store = BlockStore(num_nodes=self.lc.num_nodes)
        self.ckpt = CoreCheckpointer(self.store, code, device=str(self.dev))
        self.monitor = HostMonitor()
        self.step_fn = ts.make_train_step(self.cfg, self.api, self.ax, self.oc)
        self._state_specs = (ts.state_specs(self.cfg, self.api, self.ax, self.oc)
                             if self.mesh is not None else None)
        self.metrics_log: list[dict] = []

    def _log(self, msg: str) -> None:
        if self.rank == 0:
            print(msg)

    def _context(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        from repro_torch.launch.mesh import mesh_context

        return mesh_context(self.mesh)

    def place_state(self, state: ts.TrainState, src_rank: int | None = None) -> ts.TrainState:
        """Lay a (host/replicated) train state out on the mesh: each leaf
        a DTensor by ``state_specs``; with ``src_rank`` the values are
        that rank's (a restore), else every rank's own (the same on all).
        The identity without a mesh, or on a state already placed."""
        if self._state_specs is None or is_dtensor(state.step):
            return state
        sp = self._state_specs
        convert.distribute_params(state.params, sp.params, self.mesh, src_rank)

        def put(x, spec):
            if isinstance(x, tuple):
                return tuple(put(e, s) for e, s in zip(x, spec))
            return distribute(x, spec, self.mesh, src_rank)

        # walked in the spec tree's order, the same on every rank: a
        # restored state's dicts come back in another order on rank 0
        return ts.TrainState(state.params, tree_map(lambda s, x: put(x, s), sp.opt, state.opt),
                             put(state.step, sp.step))

    # -- state lifecycle ------------------------------------------------------

    def init_state(self) -> ts.TrainState:
        return ts.init_state(self.cfg, self.api, self.lc.seed, self.oc, device=self.dev)

    def save(self, state: ts.TrainState):
        """CORE-encode ``state`` as the reference's tree: stacked params
        (CPU tensors), the stacked optimizer state and the step. On a mesh
        every rank gathers the leaves and rank 0 stores them (the other
        ranks return None)."""
        params, opt_state, step = convert.stacked_tree(state.params), state.opt, state.step
        if self.mesh is not None:  # collectives in one order on every rank
            params = tree_map(_gathered, params)
            opt_state = tree_map(lambda _s, x: _gathered(x), self._state_specs.opt, opt_state)
            step = _gathered(step)
            if self.rank != 0:
                return None
        host_state = ts.TrainState(convert.tree_to(params, "cpu"), opt_state, step)
        return self.ckpt.save(int(step), host_state)

    def restore_latest(self) -> ts.TrainState | None:
        step = self.ckpt.latest_step() if self.rank == 0 else None
        if self.mesh is not None:
            box = [step]
            dist.broadcast_object_list(box, src=0)
            step = box[0]
        if step is None:
            return None
        if self.rank != 0:  # shapes only: the values come from rank 0
            shape = ts.state_shape(self.cfg, self.api, self.oc)
            params = self.api.init(self.cfg, None, device=self.dev)
            params.requires_grad_(True)
            def empty(t):  # a tuple leaf: the int8 v's (q, scale)
                if isinstance(t, tuple):
                    return tuple(map(empty, t))
                return torch.empty(t.shape, dtype=t.dtype, device=self.dev)

            restored = ts.TrainState(params, tree_map(empty, shape.opt), empty(shape.step))
            self.last_restore_report = None
        else:
            tree, report = self.ckpt.restore(step)
            self.last_restore_report = report
            params = convert.from_jax(tree.params, self.cfg, device=self.dev, trainable=True)
            restored = ts.TrainState(params, convert.tree_to(tree.opt, self.dev),
                                     tree.step.to(self.dev))
        return self.place_state(restored, src_rank=0)

    # -- run --------------------------------------------------------------------

    def run(self, state: ts.TrainState | None = None,
            until: int | None = None,
            on_step: Callable | None = None) -> ts.TrainState:
        if state is None:
            state = self.restore_latest() or self.init_state()
        state = self.place_state(state)
        until = until if until is not None else self.lc.steps
        start = int(_gathered(state.step))
        for step in range(start, until):
            batch = self.pipeline.device_batch(step, self.dev, self.mesh, self.ax)
            t0 = time.perf_counter()
            with self._context():
                state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.monitor.beat(f"host{self.rank}", step, dt)
            rec = {"step": step + 1, "loss": loss, "sec": dt,
                   "grad_norm": float(metrics["grad_norm"])}
            self.metrics_log.append(rec)
            if (step + 1) % self.lc.log_every == 0:
                self._log(f"step {step+1:5d}  loss {loss:.4f}  "
                          f"gnorm {rec['grad_norm']:.3f}  {dt*1e3:.0f} ms")
            if (step + 1) % self.lc.ckpt_every == 0 or step + 1 == until:
                man = self.save(state)
                if man is not None:
                    self._log(f"  ckpt @ {step+1}: {len(man.group_ids)} CORE groups, "
                              f"{man.total_bytes/1e6:.1f} MB, {man.save_seconds:.2f}s")
            if on_step is not None:
                on_step(self, state, step)
        return state


def _gathered(x):
    """A DTensor's global value on every rank (a collective); a tuple
    leaf (the int8 v) element by element; anything else as it is."""
    if isinstance(x, tuple):
        return tuple(_gathered(e) for e in x)
    return x.full_tensor() if is_dtensor(x) else x
