"""Twin of tests/test_hlo_cost.py: the trip-count-aware HLO cost analyzer
and the roofline, held field for field against the JAX package's.

The five reference cases lower the same jax programs; both parsers get
the same HLO text, and every ``Cost`` field must be equal (the reference
test's analytic counts are held on the port's numbers too). Then
``parse_collectives``, ``analyze_hlo`` and ``analyze_compiled`` on fixed
HLO text with every collective kind, the tuple form and both
``replica_groups`` forms, the port given the reference's TPU v5e figures
so that every roofline term is comparable."""

from __future__ import annotations

import dataclasses
import types

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.analysis import hlo_cost as ref_cost  # noqa: E402
from repro.analysis import roofline as ref_roof  # noqa: E402
from repro_torch.analysis import hlo_cost, roofline  # noqa: E402

# the reference's hardware model (src/repro/analysis/roofline.py:28-30),
# passed in explicitly: the port's default is the H100
V5E = roofline.Hardware(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


def _both(fn, *args):
    co = jax.jit(fn).lower(*args).compile()
    text = co.as_text()
    port, ref = hlo_cost.analyze_hlo_text(text), ref_cost.analyze_hlo_text(text)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    return port, co


def test_scan_matmul_flops_trip_scaled():
    L, B, D = 5, 8, 64

    def f(x, ws):
        def body(c, w):
            return jnp.tanh(c @ w), ()

        y, _ = jax.lax.scan(body, x, ws)
        return y.sum()

    cost, co = _both(
        f,
        jax.ShapeDtypeStruct((B, D), jnp.float32),
        jax.ShapeDtypeStruct((L, D, D), jnp.float32),
    )
    expect = 2 * B * D * D * L
    assert cost.flops == pytest.approx(expect, rel=0.02), (cost.flops, expect)
    builtin = hlo_cost.builtin_cost_dict(co)
    assert builtin == ref_cost.builtin_cost_dict(co)
    assert builtin.get("flops", 0.0) < expect / 2


def test_nested_scan_flops():
    L, M, B, D = 4, 3, 2, 16

    def f(x, ws):
        def outer(c, w):
            def inner(ci, _):
                return jnp.tanh(ci @ w), ()

            c2, _ = jax.lax.scan(inner, c, None, length=M)
            return c2, ()

        y, _ = jax.lax.scan(outer, x, ws)
        return y.sum()

    cost, _ = _both(
        f,
        jax.ShapeDtypeStruct((B, D), jnp.float32),
        jax.ShapeDtypeStruct((L, D, D), jnp.float32),
    )
    assert cost.flops == pytest.approx(2 * B * D * D * L * M, rel=0.05)


def test_dot_general_batched_flops():
    B, H, S, D = 2, 4, 32, 16

    def f(q, k):
        return jnp.einsum("bhsd,bhtd->bhst", q, k)

    cost, _ = _both(
        f,
        jax.ShapeDtypeStruct((B, H, S, D), jnp.float32),
        jax.ShapeDtypeStruct((B, H, S, D), jnp.float32),
    )
    assert cost.flops == pytest.approx(2 * B * H * S * S * D, rel=0.02)


def test_bytes_reasonable_for_elementwise():
    N = 1 << 20

    def f(x):
        return x * 2.0 + 1.0

    cost, _ = _both(f, jax.ShapeDtypeStruct((N,), jnp.float32))
    assert 0.5 * 8e6 < cost.hbm_bytes < 3 * 8e6


def test_parse_module_roundtrip_smoke():
    def f(x):
        return jnp.sin(x).sum()

    text = jax.jit(f).lower(jax.ShapeDtypeStruct((128,), jnp.float32)).compile().as_text()
    comps, entry = hlo_cost.parse_module(text)
    ref_comps, ref_entry = ref_cost.parse_module(text)
    assert entry is not None and entry == ref_entry and entry in comps
    assert comps[entry].instrs
    assert sorted(comps) == sorted(ref_comps)
    for name, comp in comps.items():
        assert [(i.name, i.op) for i in comp.instrs] == [
            (i.name, i.op) for i in ref_comps[name].instrs]
    assert hlo_cost.top_byte_ops(text) == ref_cost.top_byte_ops(text)


# -- collectives and the roofline on fixed HLO text ---------------------------

COLLECTIVES_HLO = """\
HloModule coll, entry_computation_layout={(f32[1024]{0}, bf16[64,64]{1,0})->f32[1024]{0}}

%add (x: f32[], y: f32[]) -> f32[] {
  %x = f32[] parameter(0)
  %y = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %x, f32[] %y)
}

ENTRY %main (a: f32[1024], b: bf16[64,64]) -> f32[1024] {
  %a = f32[1024]{0} parameter(0)
  %b = bf16[64,64]{1,0} parameter(1)
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %a), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[128,64]{1,0} all-gather(bf16[64,64]{1,0} %b), replica_groups=[2,2]<=[4], dimensions={0}
  %rs = f32[256]{0} reduce-scatter(f32[1024]{0} %a), replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add
  %sl = f32[512]{0} slice(f32[1024]{0} %a), slice={[0:512]}
  %a2a = (f32[512]{0}, f32[512]{0}) all-to-all(f32[512]{0} %sl, f32[512]{0} %sl), replica_groups={{0,1}}
  %cp = f32[1024]{0} collective-permute(f32[1024]{0} %a), source_target_pairs={{0,1},{1,0}}
  %ars = f32[1024]{0} all-reduce-start(f32[1024]{0} %a), replica_groups=[1,4]<=[4], to_apply=%add
  %ard = f32[1024]{0} all-reduce-done(f32[1024]{0} %ars)
  %one = f32[8]{0} all-reduce(f32[8]{0} %sl), replica_groups={{0}}, to_apply=%add
  %t = f32[1024]{0} add(f32[1024]{0} %ar, f32[1024]{0} %cp)
  ROOT %out = f32[1024]{0} add(f32[1024]{0} %t, f32[1024]{0} %ard)
}
"""


@pytest.mark.parametrize("num_devices", [1, 4, 8])
def test_parse_collectives_matches_reference(num_devices):
    port = roofline.parse_collectives(COLLECTIVES_HLO, num_devices)
    ref = ref_roof.parse_collectives(COLLECTIVES_HLO, num_devices)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    # every kind was seen: the plain, tuple and -start forms, both groups
    assert set(port.by_kind) == {"all-reduce", "all-gather", "reduce-scatter",
                                 "all-to-all", "collective-permute"}
    assert port.count >= 6 and port.wire_bytes > 0


def test_collective_cost_in_analyzer_matches_reference():
    port = hlo_cost.analyze_hlo_text(COLLECTIVES_HLO)
    ref = ref_cost.analyze_hlo_text(COLLECTIVES_HLO)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.wire_bytes > 0


def _memory_stub(text: str):
    stats = types.SimpleNamespace(temp_size_in_bytes=4096, argument_size_in_bytes=12288,
                                  output_size_in_bytes=4096, alias_size_in_bytes=1024)
    return types.SimpleNamespace(as_text=lambda: text, memory_analysis=lambda: stats)


def test_roofline_terms_match_reference_with_v5e_figures():
    kw = dict(arch="qwen2-72b", shape="train_4k", mesh_name="2x2", num_devices=4,
              model_flops_global=3.3e9)
    compiled = _memory_stub(COLLECTIVES_HLO)
    for port, ref in (
        (roofline.analyze_hlo(COLLECTIVES_HLO, hw=V5E, **kw),
         ref_roof.analyze_hlo(COLLECTIVES_HLO, **kw)),
        (roofline.analyze_compiled(compiled, hw=V5E, **kw),
         ref_roof.analyze_compiled(compiled, **kw)),
    ):
        assert port.to_dict() == ref.to_dict()
        for term in ("t_compute", "t_memory", "t_collective", "t_bound", "bottleneck",
                     "useful_flops_ratio", "mfu_bound"):
            assert getattr(port, term) == getattr(ref, term), term
    assert port.peak_mem_bytes == 4096 + 12288 + 4096 - 1024


def test_roofline_defaults_to_the_h100():
    """The port's own figures: the H100 SXM's datasheet, not the v5e's."""
    r = roofline.analyze_hlo(COLLECTIVES_HLO, arch="a", shape="s", mesh_name="1",
                             num_devices=4, model_flops_global=1.0)
    assert r.hw == roofline.H100_SXM == roofline.Hardware(989.4e12, 3.35e12, 450e9)
    assert r.t_memory == r.bytes_per_chip / 3.35e12
    assert r.t_collective == r.wire_bytes_per_chip / 450e9
    assert r.t_compute == r.flops_per_chip / 989.4e12
