"""Three-term roofline from a compiled (AOT) artifact
(src/repro/analysis/roofline.py, transcribed).

    compute   = HLO_FLOPs_per_chip / peak_FLOP/s
    memory    = HLO_bytes_per_chip / HBM_bw
    collective= wire_bytes_per_chip / link_bw

Sources: ``compiled.cost_analysis()`` (flops, bytes accessed) runs on the
post-SPMD per-partition module, so its numbers are per-chip.
Collective bytes are NOT in cost_analysis — we parse the optimized HLO
text and sum per-op wire traffic with ring-algorithm factors:

    all-reduce      2 * size * (g-1)/g     (reduce-scatter + all-gather)
    all-gather      out_size * (g-1)/g
    reduce-scatter  in_size * (g-1)/g  (= out_size * (g-1))
    all-to-all      size * (g-1)/g
    collective-permute  size

Hardware model: one ``Hardware`` record. The reference's is a TPU v5e;
the port's default is the card it runs on, ``H100_SXM``; a caller passes
another record to hold a roofline to other figures. ``analyze_compiled``
is duck-typed on ``.as_text()`` (and ``.memory_analysis()``).

PyTorch compiles nothing ahead of time, so the port's own source of the
three terms is a traced step: ``StepTrace`` runs one step eagerly on
``meta`` tensors (DTensors whose shards are ``meta`` on a mesh) under a
dispatch mode and counts, from each rank's LOCAL operands (DTensor
desugars into them; ``FlopCounterMode`` on a DTensor op would count the
global op):
  flops  2 * numel(out) * contracted size of every dot (mm, bmm, addmm,
         baddbmm, matmul, linear, einsum), as ``hlo_cost`` counts dots;
  bytes  operand + result bytes of every op that is not a view, plus K8's
         bytes for each ``meta`` launch (``selective_scan.scan_bytes``).
         Eager runs have no fusion, so this is larger than XLA's count
         of a fused program;
  wire   the collectives the step issues (``_c10d_functional`` and
         ``c10d`` ops), with ``parse_collectives``'s ring model and group
         sizes;
  peak   the largest live local-storage bytes during the step: the
         arguments plus every storage an op allocates, freed when its
         last tensor dies (as the caching allocator frees it).
``analyze_trace`` builds the ``Roofline`` from it.
"""

from __future__ import annotations

import re
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode



@dataclass(frozen=True)
class Hardware:
    peak_flops: float  # dense bf16 FLOP/s / chip
    hbm_bw: float  # bytes/s / chip
    link_bw: float  # bytes/s / link, one direction


# NVIDIA H100 SXM5 datasheet: 989.4 TFLOP/s dense bf16 (1979 with
# sparsity), HBM3 3.35 TB/s, NVLink 4 900 GB/s bidirectional = 450 GB/s
# a direction
H100_SXM = Hardware(peak_flops=989.4e12, hbm_bw=3.35e12, link_bw=450e9)

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"(\w[\w.\-]*)\s*=\s*([a-z0-9]+)\[([0-9,]*)\][^=]*?"
    r"\b(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\b"
)
_TUPLE_COLL_RE = re.compile(
    r"=\s*\(([^)]*)\)\s+(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\("
)
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims.strip():
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_BRACE_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))  # [num_groups, group_size]
    return default


@dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    by_kind: dict = field(default_factory=dict)
    count: int = 0

    def add(self, kind: str, b: float):
        self.wire_bytes += b
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + b
        self.count += 1


def parse_collectives(hlo_text: str, num_devices: int) -> CollectiveStats:
    """Per-chip wire bytes from the (post-SPMD, per-partition) HLO."""
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        if "replica_groups" not in line and "-start" not in line:
            # cheap filter; collective ops always carry replica_groups
            if not any(k in line for k in ("all-reduce", "all-gather",
                                           "reduce-scatter", "all-to-all",
                                           "collective-permute")):
                continue
        m = _COLL_RE.search(line)
        shapes = []
        if m:
            kind = m.group(4)
            shapes.append((m.group(2), m.group(3)))
        else:
            mt = _TUPLE_COLL_RE.search(line)
            if not mt:
                continue
            kind = mt.group(2)
            for sm in re.finditer(r"([a-z0-9]+)\[([0-9,]*)\]", mt.group(1)):
                shapes.append((sm.group(1), sm.group(2)))
        if kind == "collective-permute":
            g = 2
        else:
            g = _group_size(line, num_devices)
        if g <= 1:
            continue
        size = sum(_shape_bytes(dt, dm) for dt, dm in shapes)
        if kind == "all-reduce":
            b = 2.0 * size * (g - 1) / g
        elif kind == "all-gather":
            b = size * (g - 1) / g  # size = gathered output
        elif kind == "reduce-scatter":
            b = size * (g - 1)  # size = scattered output; input = size*g
        elif kind == "all-to-all":
            b = size * (g - 1) / g
        else:  # collective-permute
            b = size
        stats.add(kind, b)
    return stats


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    num_devices: int
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float
    model_flops_global: float
    peak_mem_bytes: int = 0
    coll_by_kind: dict = field(default_factory=dict)
    coll_count: int = 0
    hw: Hardware = H100_SXM

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_chip / self.hw.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs (global) — remat/redundancy waste."""
        total = self.flops_per_chip * self.num_devices
        return self.model_flops_global / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on achievable MFU under this compilation: useful
        flops / (chips * peak * bound-term time)."""
        denom = self.num_devices * self.hw.peak_flops * self.t_bound
        return self.model_flops_global / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "num_devices": self.num_devices,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "model_flops_global": self.model_flops_global,
            "peak_mem_bytes": self.peak_mem_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "coll_by_kind": self.coll_by_kind,
            "coll_count": self.coll_count,
        }


def analyze_hlo(hlo_text: str, *, arch: str, shape: str, mesh_name: str,
                num_devices: int, model_flops_global: float,
                compiled=None, hw: Hardware = H100_SXM) -> Roofline:
    """Derive the three roofline terms from (ideally) the post-SPMD,
    pre-backend HLO snapshot, against ``hw``.

    flops/bytes/wire come from the trip-count-aware HLO analyzer
    (analysis/hlo_cost.py); the builtin cost_analysis() counts
    while(scan) bodies once and is kept only as a cross-reference in
    the dry-run JSON records."""
    from repro_torch.analysis import hlo_cost

    cost = hlo_cost.analyze_hlo_text(hlo_text)
    peak = 0
    if compiled is not None:
        try:
            ma = compiled.memory_analysis()
            peak = int(
                getattr(ma, "temp_size_in_bytes", 0)
                + getattr(ma, "argument_size_in_bytes", 0)
                + getattr(ma, "output_size_in_bytes", 0)
                - getattr(ma, "alias_size_in_bytes", 0)
            )
        except Exception:
            pass
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, num_devices=num_devices,
        flops_per_chip=cost.flops, bytes_per_chip=cost.hbm_bytes,
        wire_bytes_per_chip=cost.wire_bytes,
        model_flops_global=model_flops_global,
        peak_mem_bytes=peak,
        coll_by_kind=cost.coll_by_kind, coll_count=cost.coll_count, hw=hw,
    )


def analyze_compiled(compiled, *, arch: str, shape: str, mesh_name: str,
                     num_devices: int, model_flops_global: float,
                     hw: Hardware = H100_SXM) -> Roofline:
    return analyze_hlo(
        compiled.as_text(), arch=arch, shape=shape, mesh_name=mesh_name,
        num_devices=num_devices, model_flops_global=model_flops_global,
        compiled=compiled, hw=hw,
    )


# -- the traced step (PyTorch) ----------------------------------------------

_DOTS = {"mm", "addmm", "bmm", "baddbmm", "matmul", "linear", "dot", "vdot", "mv", "addmv"}
_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
# ops with a shortcut besides the pointwise ones (StepTrace._shortcut)
_SHORTCUTS = {"cat", "stack", "slice_backward"}
# ops that move no bytes (an allocation, a view, a wait)
_NO_TRAFFIC = {"empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided",
               "detach", "wait_tensor", "lift_fresh", "alias"}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_order(t: torch.Tensor) -> bool:
    """A ``meta`` tensor whose dims of size > 1 have decreasing strides
    (contiguous, or a slice of such): an elementwise op over it writes a
    contiguous output."""
    if t.device.type != "meta":
        return False
    last = None
    for size, stride in zip(t.shape, t.stride()):
        if size == 1 or stride == 0:  # a broadcast dim
            continue
        if last is not None and stride > last:
            return False
        last = stride
    return True


def _broadcast(shapes) -> list[int]:
    out: list[int] = []
    for shape in shapes:
        shape = list(shape)
        if len(shape) > len(out):
            out = [1] * (len(shape) - len(out)) + out
        for i, d in enumerate(shape, len(out) - len(shape)):
            if d != 1:
                if out[i] not in (1, d):
                    raise RuntimeError(f"shapes do not broadcast: {shape} against {out}")
                out[i] = d
    return out


def _dot_flops(name: str, args, out) -> float:
    if name == "einsum":
        eq, ops = args[0], args[1]
        lhs, _, rhs = eq.replace(" ", "").partition("->")
        sizes = {c: d for term, t in zip(lhs.split(","), ops) for c, d in zip(term, t.shape)}
        contracted = 1
        for c in set(lhs.replace(",", "")) - set(rhs):
            contracted *= sizes[c]
        return 2.0 * out.numel() * contracted
    a = args[1] if name in ("addmm", "baddbmm", "addmv") else args[0]
    return 2.0 * out.numel() * (a.shape[-1] if a.dim() else 1)


class StepTrace(TorchDispatchMode):
    """Counts one rank's flops, bytes, collective wire bytes and peak live
    storage over the ops run inside it (see the module docstring).
    ``group_sizes`` maps each process group's name to its size (the
    mesh's groups and the world). Pointwise ops on ``meta`` tensors take
    a shortcut: torch's meta functions for them are Python (0.1-0.5 ms
    an op), so the output is made here, of the broadcast shape and of
    the dtype the op gives on one-element CPU stand-ins."""

    def __init__(self, group_sizes: dict[str, int] | None = None):
        super().__init__()
        self.group_sizes = dict(group_sizes or {})
        self.flops = 0.0
        self.bytes = 0.0
        self.k8_bytes = 0
        self.coll = CollectiveStats()
        self.ops = 0
        self.live = 0
        self.peak_live = 0
        self._alive: dict[int, int] = {}
        self._outside: set[int] = set()
        self._dtypes: dict = {}
        self._infos: dict = {}

    # -- storages ------------------------------------------------------------

    def arguments(self, tensors) -> None:
        """Mark the storages of ``tensors`` (the step's arguments, counted
        apart) as not the step's: an in-place update of one allocates
        nothing."""
        self._outside.update(id(t.untyped_storage()) for t in tensors)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._alive or key in self._outside:
                continue
            n = st.nbytes()
            self._alive[key] = n
            self.live += n
            self.peak_live = max(self.peak_live, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key, 0)

    def held(self, tree) -> int:
        """Bytes of the storages under ``tree`` that ops inside the trace
        allocated (and still live)."""
        seen = {id(t.untyped_storage()) for t in _tensors(tree)}
        return sum(self._alive.get(k, 0) for k in seen)

    # -- ops -----------------------------------------------------------------

    def _group_size(self, group) -> int:
        """A collective's group: its name (functional collectives) or the
        process group itself (``c10d`` ops pass it boxed)."""
        if isinstance(group, str):
            return self.group_sizes[group]
        if isinstance(group, torch.ScriptObject):
            import torch.distributed as dist

            group = dist.ProcessGroup.unbox(group)
        return int(group.size())

    def _collective(self, name: str, args, out) -> None:
        kind = _COLLECTIVES[name]
        if name.endswith("_"):  # c10d: (tensors, group, ...)
            tensors = _tensors(args[0])
            g = self._group_size(args[1])
            size = sum(_nbytes(t) for t in tensors)
            if kind == "all-gather":  # (outputs, inputs, group, ...)
                tensors = _tensors(args[1])
                g = self._group_size(args[2])
                size = sum(_nbytes(t) for t in tensors) * g
        else:
            g = self._group_size(args[-1])
            size = _nbytes(out) if kind in ("all-gather", "reduce-scatter") else _nbytes(args[0])
        if g <= 1:
            return
        if kind == "all-reduce":
            b = 2.0 * size * (g - 1) / g
        elif kind == "all-gather":
            b = size * (g - 1) / g
        elif kind == "reduce-scatter":
            b = size * (g - 1)
        elif kind == "all-to-all":
            b = size * (g - 1) / g
        else:
            b = size
        self.coll.add(kind, b)

    def _dtype(self, func, args, kwargs):
        """The dtype ``func`` gives on ``args``: run once on one-element
        CPU stand-ins of the same dtypes and ranks, then remembered."""
        key = (func, tuple((a.dtype, a.dim()) if isinstance(a, torch.Tensor) else type(a)
                           for a in args),
               tuple((k, v if isinstance(v, torch.dtype) else type(v))
                     for k, v in kwargs.items()))
        dtype = self._dtypes.get(key)
        if dtype is None:
            stand = [torch.ones([1] * a.dim(), dtype=a.dtype) if isinstance(a, torch.Tensor)
                     else a for a in args]
            dtype = self._dtypes[key] = func(*stand, **kwargs).dtype
        return dtype

    def _shortcut(self, func, name, args, kwargs):
        """The output of a functional pointwise op, or of ``cat``,
        ``stack`` or ``slice_backward``, on ``meta`` tensors laid out in
        order (contiguous, or strided or broadcast views of such, whose
        output is contiguous); None where that does not apply."""
        if func._schema.is_mutable or len(func._schema.returns) != 1:
            return None
        if any(isinstance(v, torch.Tensor) or k in ("out", "memory_format")
               for k, v in kwargs.items()):
            return None
        if name in ("cat", "stack") and not kwargs:
            ts, dim = list(args[0]), (args[1] if len(args) > 1 else 0)
            if name == "cat":  # cat skips legacy (0,) empties
                ts = [t for t in ts if t.dim() != 1 or t.shape[0]]
            if not ts or not all(_in_order(t) for t in ts):
                return None
            shape = list(ts[0].shape)
            if name == "cat":
                dim %= len(shape)
                shape[dim] = sum(t.shape[dim] for t in ts)
            else:
                shape.insert(dim % (len(shape) + 1), len(ts))
            dtype = ts[0].dtype
            for t in ts[1:]:
                dtype = torch.promote_types(dtype, t.dtype)
            return torch.empty(shape, dtype=dtype, device="meta")
        if name == "slice_backward" and not kwargs:  # (grad, sizes, dim, start, end, step)
            if not _in_order(args[0]):
                return None
            return torch.empty(list(args[1]), dtype=args[0].dtype, device="meta")
        if any(isinstance(a, (list, tuple)) for a in args):
            return None
        ts = [a for a in args if isinstance(a, torch.Tensor)]
        if not ts or not all(_in_order(t) for t in ts):
            return None
        return torch.empty(_broadcast(t.shape for t in ts),
                           dtype=self._dtype(func, args, kwargs), device="meta")

    def _info(self, func) -> tuple:
        """(name, takes a shortcut, a view, moves no bytes) of an op."""
        info = self._infos.get(func)
        if info is None:
            name = func._schema.name.split("::")[-1]
            info = self._infos[func] = (
                name, name in _SHORTCUTS or torch.Tag.pointwise in func.tags, func.is_view,
                func.is_view or name in _NO_TRAFFIC)
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        for t in types:
            if issubclass(t, DTensor):
                return NotImplemented  # let DTensor desugar into local ops first
            if issubclass(t, FakeTensor):
                # DTensor's sharding propagation runs the global op on fake
                # tensors to learn its output's shape: not the rank's work
                return func(*args, **kwargs)
        name, shortcut, view, no_traffic = self._info(func)
        out = self._shortcut(func, name, args, kwargs) if shortcut else None
        if out is None:
            out = func(*args, **kwargs)
            if any(isinstance(t, FakeTensor) for t in _tensors(out)):
                return out  # a factory op of the same propagation
        self.ops += 1
        if name in _COLLECTIVES:
            self._collective(name, args, out)
        elif name in _DOTS or name == "einsum":
            self.flops += _dot_flops(name, args, out)
        if not no_traffic:
            moved = _tensors(args) + _tensors(out)
            if kwargs:
                moved += _tensors(list(kwargs.values()))
            self.bytes += sum(_nbytes(t) for t in moved)
        if not view:
            self._track(out)
        return out

    def k8_launch(self, nbytes: int) -> None:
        """``selective_scan.meta_hook``: one ``meta`` launch of K8."""
        self.k8_bytes += nbytes
        self.bytes += nbytes


def analyze_trace(trace: StepTrace, *, arch: str, shape: str, mesh_name: str,
                  num_devices: int, model_flops_global: float, arg_bytes: int,
                  hw: Hardware = H100_SXM) -> Roofline:
    """The ``Roofline`` of a traced step on one rank, whose arguments
    hold ``arg_bytes`` (live all through the step)."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, num_devices=num_devices,
        flops_per_chip=trace.flops, bytes_per_chip=trace.bytes,
        wire_bytes_per_chip=trace.coll.wire_bytes,
        model_flops_global=model_flops_global,
        peak_mem_bytes=arg_bytes + trace.peak_live,
        coll_by_kind=dict(trace.coll.by_kind), coll_count=trace.coll.count, hw=hw,
    )
