"""Multi-rank dry run: trace one step of every (arch x shape) cell on a
mesh of fake ranks and capture the roofline terms
(src/repro/launch/dryrun.py).

The reference lowers and compiles each cell on 512 placeholder XLA
devices. PyTorch compiles nothing ahead of time, so the port runs the
cell's step once, eagerly, as rank 0 of a fake world: a process group
that communicates nothing (``torch.testing._internal.distributed.fake_pg``,
the one private import of the port, kept inside ``_fake_world``), a
``DeviceMesh`` over it, and every input a DTensor whose shards are
``meta`` tensors (shapes and dtypes, no storage). K8 takes its ``meta``
branch. ``analysis.roofline.StepTrace`` counts the rank's flops, bytes,
collectives and peak live storage over the step.

Usage:
  python -m repro_torch.launch.dryrun --arch falcon_mamba_7b --shape decode_32k \\
      --mesh 2x2 --devices 4 --device cpu
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod] \\
      --out build/dryrun
  (--mesh prod is the reference's 16 x 16 (2 x 16 x 16 with --multi-pod)
   TPU pod; --mesh DxM any shape, e.g. 32x8: 32 nodes of 8 NVLink-joined
   cards.)

Per cell it writes <out>/<arch>.<shape>.<mesh>[.<strategy>].json with
the reference's keys (the three roofline terms, ``kind``, ``strategy``,
``arg/temp/out_bytes_per_chip``, ``meta``), so
``benchmarks/roofline_report.py --dir <out>`` reads them; ``trace_s``
takes the place of ``lower_s`` / ``compile_s``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.kernels.backend import resolve_device

# The per-rank memory budget of an H100 80GB HBM3 (700 W), measured on
# the card by ``chip_smoke.py`` phase 13: its ``total_memory``
# (85,017,493,504 bytes) less what lies outside the caching allocator
# (787,415,040: the CUDA context and libraries) less the allocator's
# headroom (4,248,475,648: reserved - allocated at the peak of phase
# 8(b)'s train step). The reference's 14e9 is a 16 GB TPU v5e's.
HBM_BUDGET = 79_981_602_816


def _fake_world(n: int) -> None:
    """Make this process rank 0 of a fake world of ``n`` ranks (no
    communication), unless a process group is already up."""
    if dist.is_initialized():
        if dist.get_world_size() < n:
            raise ValueError(f"a world of {dist.get_world_size()} ranks is up; {n} wanted")
        return
    # a private module (torch 2.11 and 2.13 both have it): the dry run
    # is its only user in the port
    from torch.testing._internal.distributed import fake_pg

    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0, world_size=n)
    print(f"fake world: {n} ranks, this process rank 0 (torch {torch.__version__}, "
          "torch.testing._internal.distributed.fake_pg)")


def _mesh_from_arg(arg: str, multi_pod: bool, device=None):
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    if arg == "prod":
        return make_production_mesh(multi_pod=multi_pod, device=device), (
            "pod2x16x16" if multi_pod else "pod16x16"
        )
    dims = tuple(int(x) for x in arg.split("x"))
    axes = ("pod", "data", "model")[-len(dims):]
    return make_mesh(dims, axes, device=device), arg


def _mesh_size(arg: str, multi_pod: bool) -> int:
    if arg == "prod":
        return 512 if multi_pod else 256
    return math.prod(int(x) for x in arg.split("x"))


def pick_strategy(cfg, cell_shape, mesh, *, hbm_budget: float = HBM_BUDGET) -> str:
    """Beyond-paper sharding strategy per cell: train -> pure-FSDP when
    the global batch covers the mesh and the state+saves fit; decode ->
    TP-only (weights replicated over data) when bf16 params/tp + the
    cache shard fit ``hbm_budget``; else the 2-D Megatron x ZeRO
    default."""
    from repro_torch.launch.specs import param_count
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import axes_for_mesh as afm
    from repro_torch.models.stack import tree_leaves

    api = get_model(cfg)
    n_params = param_count(cfg, api)
    n_dev = mesh.mesh.numel()
    shape_d = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    tp = shape_d.get("model", 1)
    if cell_shape.kind == "train":
        ax = afm(mesh, strategy="fsdp")
        if cell_shape.global_batch % max(ax.dp_size, 1):
            return "2d"
        state = n_params * 10 / ax.fsdp_size  # bf16 p + f32 m + f32 v
        tokens_per_chip = cell_shape.global_batch * cell_shape.seq_len / n_dev
        block = cfg.remat_block or cfg.num_layers
        layers_saved = (cfg.num_layers // block) if cfg.remat_block else cfg.num_layers
        saves = layers_saved * tokens_per_chip * cfg.d_model * 2
        return "fsdp" if state + saves < hbm_budget else "2d"
    if cell_shape.kind == "decode":
        cache = api.cache_shape(cfg, cell_shape.global_batch, cell_shape.seq_len)
        cache_bytes = sum(math.prod(s.shape) * s.dtype.itemsize
                          for s in tree_leaves(cache)) / n_dev
        if n_params * 2 / tp + cache_bytes < hbm_budget:
            return "tp_only"
    return "2d"


def _leaves(x) -> list:
    """The tensor leaves of a step's inputs or outputs: a model's
    parameters, a TrainState's fields, dicts, lists and tuples."""
    from torch import nn

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, nn.Module):
        return list(x.parameters())
    if hasattr(x, "tree_flatten"):
        return _leaves(list(x.tree_flatten()[0]))
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _local_bytes(t: torch.Tensor) -> int:
    from repro_torch.models.shardings import is_dtensor

    loc = t.to_local() if is_dtensor(t) else t
    return loc.numel() * loc.element_size()


def _place(args, specs, mesh):
    """The cell's inputs on ``mesh``: the model's parameters replaced by
    DTensors in place (``convert.distribute_params``), every other leaf
    (a ``meta`` tensor or a ``TensorSpec``) a DTensor with ``meta``
    shards laid out by its spec."""
    from torch import nn

    from repro_torch.models import convert
    from repro_torch.models.layers import TensorSpec
    from repro_torch.models.shardings import distribute
    from repro_torch.models.stack import tree_map
    from repro_torch.train.train_step import TrainState

    def put(x, spec):
        if isinstance(x, TensorSpec):
            x = torch.empty(x.shape, dtype=x.dtype, device="meta")
        if isinstance(x, tuple):
            return tuple(put(e, s) for e, s in zip(x, spec))
        return distribute(x, spec, mesh)

    def place(x, spec):
        if isinstance(x, nn.Module):
            convert.distribute_params(x, spec, mesh)
            return x
        if isinstance(x, TrainState):  # trainable, as ts.init_state makes it
            x.params.requires_grad_(True)
            return TrainState(place(x.params, spec.params),
                              tree_map(lambda s, v: put(v, s), spec.opt, x.opt),
                              put(x.step, spec.step))
        return tree_map(lambda s, v: put(v, s), spec, x)

    return tuple(place(a, s) for a, s in zip(args, specs))


def _on_meta(args):
    """The cell's inputs with no mesh: every ``TensorSpec`` an empty
    ``meta`` tensor, the train state's parameters trainable."""
    from repro_torch.models.layers import TensorSpec
    from repro_torch.models.stack import tree_map
    from repro_torch.train.train_step import TrainState

    def leaf(x):
        if isinstance(x, TensorSpec):
            return torch.empty(x.shape, dtype=x.dtype, device="meta")
        return x

    out = []
    for a in args:
        if isinstance(a, TrainState):
            a.params.requires_grad_(True)
        elif isinstance(a, (dict, list, TensorSpec)):
            a = tree_map(leaf, a)
        out.append(a)
    return tuple(out)


def _group_sizes(mesh) -> dict[str, int]:
    sizes = {dist.group.WORLD.group_name: dist.get_world_size()}
    for i in range(mesh.ndim):
        g = mesh.get_group(i)
        sizes[g.group_name] = g.size()
    return sizes


def run_cell(arch: str, shape: str, mesh, mesh_name: str, out_dir: str | None,
             verbose: bool = True, strategy: str = "2d", cfg=None) -> dict:
    """Trace one cell's step on ``mesh`` (rank 0's shard) and return its
    record. ``mesh`` None is a world of 1 with no mesh: the single-card
    step on plain ``meta`` tensors. ``shape`` is a ``SHAPES`` name or a
    ``ShapeCell``; ``cfg`` overrides ``get_config(arch)`` (a cut
    configuration)."""
    import contextlib

    from repro_torch.analysis.roofline import StepTrace, analyze_trace
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import selective_scan as k8
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import SINGLE, axes_for_mesh

    cfg = cfg or get_config(arch)
    cell_shape = SHAPES[shape] if isinstance(shape, str) else shape
    shape = cell_shape.name
    api = get_model(cfg)
    if mesh is None:
        ax, strategy, n_dev = SINGLE, "2d", 1
    else:
        if strategy == "auto":
            strategy = pick_strategy(cfg, cell_shape, mesh)
        ax = axes_for_mesh(mesh, strategy=strategy)
        if strategy == "fsdp" and (cell_shape.kind != "train"
                                   or cell_shape.global_batch % max(ax.dp_size, 1)):
            ax = axes_for_mesh(mesh)  # strategy is train-only / batch-divisible
            strategy = "2d"
        n_dev = mesh.mesh.numel()

    t0 = time.perf_counter()
    cell = input_specs(cfg, cell_shape, api, ax)
    args = _place(cell.args, cell.in_specs, mesh) if mesh is not None else _on_meta(cell.args)
    if cell.kind == "decode":
        # pos: the reference's int32 scalar, a Python int here (the ring
        # slot is host arithmetic), so no argument bytes; the last slot of
        # the cache (a full cache: every slot attended)
        args = (*args[:3], cell_shape.seq_len - 1)
    local = [t.to_local() if hasattr(t, "to_local") else t for t in _leaves(args)]
    arg_bytes = sum(t.numel() * t.element_size() for t in local)
    trace = StepTrace(_group_sizes(mesh) if mesh is not None else {})
    trace.arguments(local)
    k8.meta_hook = trace.k8_launch
    try:
        with mesh_context(mesh) if mesh is not None else contextlib.nullcontext(), trace:
            out = cell.step(*args)
    finally:
        k8.meta_hook = None
    t_trace = time.perf_counter() - t0
    out_leaves = _leaves(out)
    # XLA's output tuple holds an 8-byte pointer a leaf, which the
    # reference's output_size_in_bytes counts: counted the same here
    out_bytes = sum(_local_bytes(t) for t in out_leaves) + 8 * len(out_leaves)
    out_new = trace.held([t.to_local() if hasattr(t, "to_local") else t for t in out_leaves])
    roof = analyze_trace(trace, arch=arch, shape=shape, mesh_name=mesh_name, num_devices=n_dev,
                         model_flops_global=cell.model_flops, arg_bytes=arg_bytes)
    temp_bytes = trace.peak_live - out_new
    if verbose:
        print(f"TracedMemoryStats(argument_size_in_bytes={arg_bytes}, "
              f"output_size_in_bytes={out_bytes}, temp_size_in_bytes={temp_bytes}, "
              f"peak_bytes={roof.peak_mem_bytes}, hbm_budget={HBM_BUDGET})")
        print(f"traced cost (per rank, eager ops, no fusion): flops={trace.flops:.3e} "
              f"bytes={trace.bytes:.3e} (K8 {trace.k8_bytes:.3e}) ops={trace.ops}")

    rec = roof.to_dict()
    rec.update(
        kind=cell.kind,
        strategy=strategy,
        trace_s=round(t_trace, 2),
        arg_bytes_per_chip=int(arg_bytes),
        temp_bytes_per_chip=int(temp_bytes),
        out_bytes_per_chip=int(out_bytes),
        hbm_budget=HBM_BUDGET,
        layers=cfg.num_layers,
        traced_ops=trace.ops,
        k8_bytes=trace.k8_bytes,
        torch=torch.__version__,
        meta=cell.meta,
    )
    if verbose:
        print(
            f"[{arch} x {shape} x {mesh_name}] kind={cell.kind} "
            f"t_comp={roof.t_compute*1e3:.2f}ms t_mem={roof.t_memory*1e3:.2f}ms "
            f"t_coll={roof.t_collective*1e3:.2f}ms bound={roof.bottleneck} "
            f"useful={roof.useful_flops_ratio:.2f} mfu_bound={roof.mfu_bound:.2f}"
        )
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "" if strategy == "2d" else f".{strategy}"
        fn = os.path.join(out_dir, f"{arch}.{shape}.{mesh_name}{suffix}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="prod", help='"prod" or e.g. "4x4"')
    ap.add_argument("--out", default=None)
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of the fake world (default: the mesh's size)")
    ap.add_argument("--strategy", default="2d", choices=["2d", "fsdp", "tp_only", "auto"],
                    help="train-cell sharding strategy (see shardings.axes_for_mesh)")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type: the card by default, 'cpu' when asked")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_IDS, SHAPES

    dev = resolve_device(args.device)
    _fake_world(args.devices or _mesh_size(args.mesh, args.multi_pod))
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    mesh, mesh_name = _mesh_from_arg(args.mesh, args.multi_pod, device=dev.type)

    failures = []
    for arch in archs:
        for shape in shapes:
            try:
                run_cell(arch, shape, mesh, mesh_name, args.out, strategy=args.strategy)
            except Exception:
                traceback.print_exc()
                failures.append((arch, shape))
            sys.stdout.flush()
    if failures:
        print("FAILED cells:", failures)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
