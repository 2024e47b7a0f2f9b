"""Trip-count-aware cost analysis over optimized HLO text
(src/repro/analysis/hlo_cost.py, transcribed: a framework-free parser,
it imports only ``re`` and ``dataclasses``).

Why this exists: XLA's ``compiled.cost_analysis()`` counts a ``while``
body ONCE — a lax.scan over 88 layers under-reports flops/bytes by ~88x,
and collectives inside the scanned body are likewise counted once. All
our layer stacks are scanned (stack.py), so the built-in numbers are
useless for rooflines. This module re-derives

    flops       — 2 * numel(result) * prod(contracting dims) per dot,
                  multiplied through enclosing while trip counts
                  (``backend_config known_trip_count``, with a
                  constant-compare fallback),
    hbm bytes   — sum of operand+result sizes at fusion boundaries
                  (fusion internals are VMEM/register traffic),
    wire bytes  — ring-model per-chip bytes for every collective
                  (all-reduce 2s(g-1)/g, all-gather/all-to-all s(g-1)/g,
                  reduce-scatter s(g-1), permute s), x trip counts,

by parsing the post-SPMD, per-partition HLO module — so every number is
per-chip. Validated against analytic counts in tests/test_hlo_cost.py,
and field for field against the reference's parser on the same HLO text
in tests/test_torch_hlo_cost.py. The port compiles no HLO itself: its
torch source for these entries comes with the dry run.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "u2": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\](?:\{[^}]*\})?")
_COMP_HDR_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s+\((.*)\)\s+->\s+(.+)\s+\{\s*$")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s+=\s+(.+?)\s+([a-z][\w\-]*)\((.*)$"
)
_CALLS_RE = re.compile(r"(?:calls|body|condition|to_apply)=%?([\w.\-]+)")
_BODY_RE = re.compile(r"body=%?([\w.\-]+)")
_COND_RE = re.compile(r"condition=%?([\w.\-]+)")
_TRIP_RE = re.compile(r'known_trip_count[^}]*?"n"\s*:\s*"?(\d+)"?')
_LHS_C_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")
_RHS_C_RE = re.compile(r"rhs_contracting_dims=\{([0-9,]*)\}")
_LHS_B_RE = re.compile(r"lhs_batch_dims=\{([0-9,]*)\}")
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)


def _shape_list(type_str: str) -> list[tuple[str, tuple[int, ...]]]:
    """'(s32[], f32[8,64]{1,0})' -> [('s32', ()), ('f32', (8, 64))]."""
    out = []
    for m in _SHAPE_RE.finditer(type_str):
        dims = tuple(int(x) for x in m.group(2).split(",")) if m.group(2) else ()
        out.append((m.group(1), dims))
    return out


def _nbytes(shapes) -> int:
    total = 0
    for dt, dims in shapes:
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES.get(dt, 4)
    return total


def _numel(dims) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


@dataclass
class Instr:
    name: str
    op: str
    result: list  # [(dtype, dims)]
    operands: list  # operand names (may be empty for inline constants)
    tail: str  # rest of line (attrs)
    raw: str = ""  # full line (constant literals live in the operand slot)


@dataclass
class Computation:
    name: str
    params: dict  # name -> [(dtype, dims)]
    instrs: list
    symbols: dict  # name -> [(dtype, dims)]
    root: str | None = None


def _split_top(s: str) -> list[str]:
    """Split on commas not nested in (), [], {}."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def parse_module(text: str):
    """-> (computations dict, entry computation name)."""
    comps: dict[str, Computation] = {}
    entry = None
    cur: Computation | None = None
    for raw in text.splitlines():
        line = raw.rstrip()
        m = _COMP_HDR_RE.match(line.strip())
        if m and not line.strip().startswith("//"):
            params = {}
            for part in _split_top(m.group(3)):
                part = part.strip()
                if not part or ":" not in part:
                    continue
                pname, ptype = part.split(":", 1)
                params[pname.strip().lstrip("%")] = _shape_list(ptype)
            cur = Computation(m.group(2), params, [], dict(params))
            comps[cur.name] = cur
            if m.group(1):
                entry = cur.name
            continue
        if cur is None:
            continue
        if line.strip() == "}":
            cur = None
            continue
        mi = _INSTR_RE.match(line)
        if not mi:
            continue
        name, type_str, op, rest = mi.groups()
        if line.lstrip().startswith("ROOT"):
            cur.root = name
        # split rest into "operands) tail"
        depth, i = 1, 0
        while i < len(rest) and depth:
            if rest[i] in "([{":
                depth += 1
            elif rest[i] in ")]}":
                depth -= 1
            i += 1
        opnds_str, tail = rest[: i - 1], rest[i:]
        operands = []
        for part in _split_top(opnds_str):
            part = part.strip()
            mm = re.search(r"%([\w.\-]+)\s*$", part)
            if mm:
                operands.append(mm.group(1))
        result = _shape_list(type_str)
        instr = Instr(name, op, result, operands, tail, raw=line)
        cur.instrs.append(instr)
        cur.symbols[name] = result
    return comps, entry


@dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    coll_by_kind: dict = field(default_factory=dict)
    coll_count: int = 0
    unknown_trip_whiles: int = 0

    def __iadd__(self, o: "Cost"):
        self.flops += o.flops
        self.hbm_bytes += o.hbm_bytes
        self.wire_bytes += o.wire_bytes
        for k, v in o.coll_by_kind.items():
            self.coll_by_kind[k] = self.coll_by_kind.get(k, 0.0) + v
        self.coll_count += o.coll_count
        self.unknown_trip_whiles += o.unknown_trip_whiles
        return self

    def scaled(self, f: float) -> "Cost":
        return Cost(
            self.flops * f, self.hbm_bytes * f, self.wire_bytes * f,
            {k: v * f for k, v in self.coll_by_kind.items()},
            int(self.coll_count * f), self.unknown_trip_whiles,
        )


def _group_size(tail: str, default: int) -> int:
    m = _GROUPS_BRACE_RE.search(tail)
    if m:
        return len(m.group(1).split(","))
    m = _GROUPS_IOTA_RE.search(tail)
    if m:
        return int(m.group(2))
    return default


def _dot_flops(instr: Instr, sym: dict) -> float:
    out_numel = sum(_numel(d) for _, d in instr.result)
    mc = _LHS_C_RE.search(instr.tail)
    lhs = sym.get(instr.operands[0]) if instr.operands else None
    if not mc or not lhs:
        return 2.0 * out_numel  # degenerate
    cdims = [int(x) for x in mc.group(1).split(",") if x]
    contract = 1
    for ci in cdims:
        if ci < len(lhs[0][1]):
            contract *= lhs[0][1][ci]
    return 2.0 * out_numel * contract


def _trip_count(instr: Instr, comps: dict) -> int | None:
    m = _TRIP_RE.search(instr.tail)
    if m:
        return int(m.group(1))
    mc = _COND_RE.search(instr.tail)
    if mc and mc.group(1) in comps:
        # fallback: largest integer constant in the condition computation
        best = None
        for ci in comps[mc.group(1)].instrs:
            if ci.op == "constant" and ci.result and ci.result[0][0].startswith("s"):
                mm = re.search(r"constant\((-?\d+)\)", ci.raw or ci.tail)
                if mm:
                    v = int(mm.group(1))
                    best = v if best is None else max(best, v)
        return best
    return None


def _op_bytes(instr: Instr, sym: dict) -> float:
    out_b = _nbytes(instr.result)
    in_b = 0
    for o in instr.operands:
        if o in sym:
            in_b += _nbytes(sym[o])
    if instr.op in ("dynamic-update-slice", "scatter"):
        # output aliases the big operand: traffic ~ 2x update size
        upd = _nbytes(sym.get(instr.operands[1], [])) if len(instr.operands) > 1 else 0
        return 2.0 * upd
    if instr.op in _SLICE_OPS:
        return 2.0 * out_b
    return float(out_b + in_b)


_SKIP_BYTES_OPS = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "after-all", "iota", "reshape", "broadcast", "partition-id",
    "replica-id",
    # convert/copy fuse with their producer/consumer on TPU; their data
    # movement is already charged at the neighbouring materialization
    # points (the CPU backend's hoisted bf16->f32 dot-operand converts
    # would otherwise dominate every byte count)
    "convert", "copy",
}

_SLICE_OPS = {"dynamic-slice", "slice", "gather"}

# ops whose output is a view / free relabeling — no HBM traffic of their own,
# reads pass through to their producers
_VIEW_OPS = {
    "bitcast", "reshape", "get-tuple-element", "tuple", "broadcast",
    "transpose", "convert", "copy", "after-all", "optimization-barrier",
}

# ops that force their result (and operand reads) through HBM
_MATERIAL_OPS = {
    "dot", "convolution", "reduce", "reduce-window", "sort", "scatter",
    "gather", "dynamic-slice", "slice", "dynamic-update-slice",
    "concatenate", "pad", "reverse", "cholesky", "triangular-solve",
    "rng", "rng-bit-generator", "custom-call", "fft",
    "select-and-scatter", "fusion",
}


class _FusionModel:
    """Producer-fusion byte model for (pre-backend, unfused) HLO.

    A single-use elementwise op fuses into its consumer: it writes
    nothing, and its reads are charged at the consuming materialization
    point. Values materialize when produced by a _MATERIAL_OPS op, used
    more than once, feeding the computation root, or entering/leaving
    the computation (parameters). This approximates what the TPU
    fusion pass actually does, without depending on any backend."""

    def __init__(self, comp: Computation):
        self.comp = comp
        self.defs = {i.name: i for i in comp.instrs}
        uses: dict[str, int] = {}
        for i in comp.instrs:
            for o in i.operands:
                uses[o] = uses.get(o, 0) + 1
        self.uses = uses
        # values reaching the root through pure views must materialize
        self.root_mat: set[str] = set()
        if comp.root:
            stack = [comp.root]
            seen = set()
            while stack:
                nm = stack.pop()
                if nm in seen:
                    continue
                seen.add(nm)
                d = self.defs.get(nm)
                if d is None:
                    self.root_mat.add(nm)
                elif d.op in _VIEW_OPS:
                    stack.extend(d.operands)
                else:
                    self.root_mat.add(nm)
        self._reads_memo: dict[str, dict] = {}

    def materialized(self, name: str) -> bool:
        d = self.defs.get(name)
        if d is None:  # computation parameter (or cross-comp ref)
            return True
        if d.op in _VIEW_OPS:
            return False
        if d.op in _MATERIAL_OPS or d.op == "while" or d.op == "parameter":
            return True
        if d.op == "constant":
            return True
        if any(d.op.startswith(c) or d.op.rstrip("-start").startswith(c)
               for c in _COLLECTIVES):
            return True
        return self.uses.get(name, 0) > 1 or name in self.root_mat

    def reads(self, name: str) -> dict:
        """-> {materialized source name: bytes} feeding ``name``."""
        if name in self._reads_memo:
            return self._reads_memo[name]
        self._reads_memo[name] = {}  # cycle guard
        d = self.defs.get(name)
        if d is not None and d.op == "get-tuple-element":
            # reading one tuple element only — never the whole carry
            src = self.defs.get(d.operands[0]) if d.operands else None
            if src is not None and src.op == "tuple":
                m = re.search(r"index=(\d+)", d.tail)
                idx = int(m.group(1)) if m else 0
                if idx < len(src.operands):
                    out = self.reads(src.operands[idx])
                    self._reads_memo[name] = out
                    return out
            out = {name: float(_nbytes(d.result))}
            self._reads_memo[name] = out
            return out
        if d is None or self.materialized(name):
            out = {name: float(_nbytes(self.comp.symbols.get(name, [])))}
        else:
            out = {}
            for o in d.operands:
                for k, v in self.reads(o).items():
                    out[k] = v
        self._reads_memo[name] = out
        return out

    def read_bytes(self, instr: Instr) -> float:
        out: dict[str, float] = {}
        for oi, o in enumerate(instr.operands):
            if instr.op in _SLICE_OPS and oi == 0:
                # slicing a materialized buffer reads ~the slice
                out[f"{o}#slice{oi}"] = float(_nbytes(instr.result))
                continue
            if instr.op in ("dynamic-update-slice", "scatter") and oi == 0:
                continue  # aliased destination
            for k, v in self.reads(o).items():
                out[k] = v
        return sum(out.values())


def _fusion_bytes(instr: Instr, comp: Computation, comps: dict) -> float:
    """HBM traffic of one fusion: reads of each fusion parameter (a
    parameter consumed only through a slice/gather counts the slice
    size), plus the root write (DUS/scatter roots alias their big
    operand: 2 x update size)."""
    m = _CALLS_RE.search(instr.tail)
    called = comps.get(m.group(1)) if m else None
    if called is None:
        return _op_bytes(instr, comp.symbols)
    defs = {i.name: i for i in called.instrs}
    _VIEW = ("convert", "bitcast", "copy", "reshape", "transpose", "broadcast")

    def resolve(name: str, depth=8) -> str:
        while depth and name in defs and defs[name].op in _VIEW and defs[name].operands:
            name = defs[name].operands[0]
            depth -= 1
        return name

    # params whose data is only the aliased destination of a DUS/scatter
    aliased_params: set[str] = set()
    dus_updates = 0.0
    dus_names: set[str] = set()
    for inner in called.instrs:
        if inner.op in ("dynamic-update-slice", "scatter"):
            dus_names.add(inner.name)
            if inner.operands:
                dst = resolve(inner.operands[0])
                if dst in called.params:
                    aliased_params.add(dst)
            if len(inner.operands) > 1:
                dus_updates += _nbytes(called.symbols.get(inner.operands[1], []))
    root_is_aliasing = called.root is not None and resolve(called.root) in dus_names

    reads: dict[str, float] = {}
    for inner in called.instrs:
        for oi, opd in enumerate(inner.operands):
            if opd not in called.params or opd in aliased_params:
                continue
            full = _nbytes(called.params[opd])
            if inner.op in _SLICE_OPS and oi == 0:
                sz = min(full, float(_nbytes(inner.result)))
            else:
                sz = float(full)
            reads[opd] = max(reads.get(opd, 0.0), sz)
    write = 2.0 * dus_updates if root_is_aliasing else float(_nbytes(instr.result))
    return sum(reads.values()) + write


def _instr_cost(instr: Instr, comp: Computation, comps: dict, memo: dict,
                fm: "_FusionModel") -> Cost:
    """Cost of one instruction under the producer-fusion byte model."""
    op = instr.op
    if op.endswith("-done"):
        return Cost()
    base = op[:-6] if op.endswith("-start") else op

    if base in ("dot", "dot-general"):
        return Cost(flops=_dot_flops(instr, comp.symbols),
                    hbm_bytes=fm.read_bytes(instr) + _nbytes(instr.result))
    if base == "convolution":
        out_numel = sum(_numel(d) for _, d in instr.result)
        return Cost(flops=2.0 * out_numel,
                    hbm_bytes=fm.read_bytes(instr) + _nbytes(instr.result))
    if any(base.startswith(c) for c in _COLLECTIVES):
        kind = next(c for c in _COLLECTIVES if base.startswith(c))
        size = _nbytes(instr.result)
        if op.endswith("-start") and len(instr.result) > 1:
            size = size / 2
        g = 2 if kind == "collective-permute" else _group_size(instr.tail, 2)
        if g <= 1:
            return Cost()
        if kind == "all-reduce":
            wire = 2.0 * size * (g - 1) / g
        elif kind == "reduce-scatter":
            wire = size * (g - 1)
        elif kind == "collective-permute":
            wire = size
        else:
            wire = size * (g - 1) / g
        c = Cost(wire_bytes=wire, hbm_bytes=2.0 * size)
        c.coll_by_kind[kind] = wire
        c.coll_count = 1
        return c
    if op == "while":
        mb = _BODY_RE.search(instr.tail)
        mc = _COND_RE.search(instr.tail)
        trips = _trip_count(instr, comps)
        sub = Cost()
        hoisted = Cost()
        if mb and mb.group(1) in comps:
            sub += cost_of(mb.group(1), comps, memo)
            hoisted += _hoistable_cost(comps[mb.group(1)], comps)
        if mc and mc.group(1) in comps:
            sub += cost_of(mc.group(1), comps, memo)
        if trips is None:
            trips = 1
            sub.unknown_trip_whiles += 1
        # loop-invariant collectives are hoisted by LICM on the real
        # pipeline: count them once, not x trips
        sub = Cost(
            sub.flops - hoisted.flops, sub.hbm_bytes - hoisted.hbm_bytes,
            sub.wire_bytes - hoisted.wire_bytes,
            {k: sub.coll_by_kind.get(k, 0.0) - hoisted.coll_by_kind.get(k, 0.0)
             for k in sub.coll_by_kind},
            sub.coll_count - hoisted.coll_count, sub.unknown_trip_whiles,
        )
        out = sub.scaled(trips)
        out += hoisted
        return out
    if op in ("call", "conditional", "map"):
        out = Cost()
        for mm in _CALLS_RE.finditer(instr.tail):
            if mm.group(1) in comps:
                out += cost_of(mm.group(1), comps, memo)
        return out
    if op == "fusion":
        # backend-fused node (post-optimization HLO): boundary traffic
        out = Cost(hbm_bytes=_fusion_bytes(instr, comp, comps))
        mcall = _CALLS_RE.search(instr.tail)
        if mcall and mcall.group(1) in comps:
            inner = cost_of(mcall.group(1), comps, memo)
            out += Cost(flops=inner.flops, wire_bytes=inner.wire_bytes,
                        coll_by_kind=dict(inner.coll_by_kind),
                        coll_count=inner.coll_count,
                        unknown_trip_whiles=inner.unknown_trip_whiles)
        return out
    if op in ("dynamic-update-slice", "scatter"):
        upd = (_nbytes(comp.symbols.get(instr.operands[1], []))
               if len(instr.operands) > 1 else 0)
        return Cost(hbm_bytes=2.0 * upd)
    if op in _SLICE_OPS:
        return Cost(hbm_bytes=fm.read_bytes(instr) + _nbytes(instr.result))
    if op in ("reduce", "reduce-window", "sort", "select-and-scatter",
              "custom-call", "concatenate", "pad", "reverse", "fft",
              "cholesky", "triangular-solve", "rng", "rng-bit-generator"):
        return Cost(hbm_bytes=fm.read_bytes(instr) + _nbytes(instr.result))
    if op in _VIEW_OPS or op in _SKIP_BYTES_OPS:
        return Cost()
    # elementwise (default): free unless it materializes
    if fm.materialized(instr.name):
        return Cost(hbm_bytes=fm.read_bytes(instr) + _nbytes(instr.result))
    return Cost()


def _invariant_names(body: Computation) -> set[str]:
    """Values in a while body that do not depend on loop-varying state
    (hoistable by LICM). A GTE of the loop tuple is invariant when the
    body's root passes that element through untouched."""
    defs = {i.name: i for i in body.instrs}
    _VIEWS = ("bitcast", "reshape", "copy", "convert")

    def resolve(name, depth=6):
        while depth and name in defs and defs[name].op in _VIEWS and defs[name].operands:
            name = defs[name].operands[0]
            depth -= 1
        return name

    root = defs.get(resolve(body.root)) if body.root else None
    passthrough: set[int] = set()
    if root is not None and root.op == "tuple":
        for i, o in enumerate(root.operands):
            d = defs.get(resolve(o))
            if d is not None and d.op == "get-tuple-element":
                m = re.search(r"index=(\d+)", d.tail)
                if m and int(m.group(1)) == i:
                    passthrough.add(i)
    inv: dict[str, bool] = {}

    def is_inv(name, depth=0) -> bool:
        if name in inv:
            return inv[name]
        if depth > 200:
            return False
        d = defs.get(name)
        if d is None:
            inv[name] = False  # the loop param itself
            return False
        inv[name] = False  # cycle guard
        if d.op == "parameter":
            return False
        if d.op in ("constant", "iota", "partition-id", "replica-id"):
            inv[name] = True
            return True
        if d.op == "get-tuple-element" and d.operands:
            src = defs.get(d.operands[0])
            if src is None or (src.op == "parameter"):
                m = re.search(r"index=(\d+)", d.tail)
                ok = bool(m) and int(m.group(1)) in passthrough
                inv[name] = ok
                return ok
        ok = all(is_inv(o, depth + 1) for o in d.operands) if d.operands else False
        inv[name] = ok
        return ok

    return {i.name for i in body.instrs
            if any(i.op.startswith(c) or (i.op.endswith("-start") and
                                          i.op[:-6].startswith(c))
                   for c in _COLLECTIVES)
            and all(is_inv(o) for o in i.operands)}


def _hoistable_cost(body: Computation, comps: dict) -> Cost:
    names = _invariant_names(body)
    if not names:
        return Cost()
    fm = _FusionModel(body)
    total = Cost()
    for instr in body.instrs:
        if instr.name in names:
            total += _instr_cost(instr, body, comps, {}, fm)
    return total


def cost_of(comp_name: str, comps: dict, memo: dict) -> Cost:
    if comp_name in memo:
        return memo[comp_name]
    comp = comps[comp_name]
    fm = _FusionModel(comp)
    total = Cost()
    for instr in comp.instrs:
        total += _instr_cost(instr, comp, comps, memo, fm)
    memo[comp_name] = total
    return total


def analyze_hlo_text(text: str) -> Cost:
    comps, entry = parse_module(text)
    if entry is None:
        # pick the computation named like ENTRY fallback: largest
        entry = max(comps, key=lambda c: len(comps[c].instrs)) if comps else None
    if entry is None:
        return Cost()
    return cost_of(entry, comps, {})


def builtin_cost_dict(compiled) -> dict:
    """Duck-typed over ``compiled.cost_analysis()``: a dict, or a
    one-element list of dicts (per partition), as compilers return it."""
    cost = compiled.cost_analysis()
    if isinstance(cost, dict):
        return cost
    if isinstance(cost, (list, tuple)) and cost and isinstance(cost[0], dict):
        return cost[0]
    return {}


def top_byte_ops(text: str, n: int = 20, key: str = "hbm_bytes"):
    """Debug: (bytes x trips, op, name) attribution of hbm_bytes (or
    wire_bytes with key="wire_bytes")."""
    comps, entry = parse_module(text)
    if entry is None:
        return []
    rows = []

    def walk(comp_name: str, mult: float):
        comp = comps[comp_name]
        fm = _FusionModel(comp)
        for instr in comp.instrs:
            op = instr.op
            if op == "while":
                mb = _BODY_RE.search(instr.tail)
                trips = _trip_count(instr, comps) or 1
                if mb and mb.group(1) in comps:
                    walk(mb.group(1), mult * trips)
                continue
            if op in ("call", "conditional", "map"):
                for mm in _CALLS_RE.finditer(instr.tail):
                    if mm.group(1) in comps:
                        walk(mm.group(1), mult)
                continue
            c = _instr_cost(instr, comp, comps, {}, fm)
            v = getattr(c, key)
            if v:
                rows.append((v * mult, op, f"{comp_name}/{instr.name}"))

    walk(entry, 1.0)
    rows.sort(reverse=True)
    return rows[:n]
