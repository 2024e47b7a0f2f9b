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
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field



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
