"""Twins of src/repro/launch/specs.py and the dry run's strategy pick:
``param_count``, ``active_params`` and ``model_flops`` equal to the JAX
package's for every id and shape cell; ``input_specs``' argument trees
(shapes and dtypes, the parameters as the reference's stacked tree) and
spec trees leaf for leaf, on the production 16 x 16 axes and on a 2 x 2
``fsdp`` mesh; ``serve_step.decode_input_shapes``; ``pick_strategy`` at
the reference's 14e9 budget on the 16 x 16 shape, the reference's in a
subprocess with 256 placeholder XLA devices. Both packages' ``MeshAxes``
come from mesh stand-ins that carry a mesh's names and shape. Then K8's
``meta`` branch: shapes only, no launch, no plain loop."""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import types

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import shardings as jsh  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro.serve import serve_step as jss  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.layers import fit_chunk  # noqa: E402
from repro_torch.models import shardings as sh  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve import serve_step as ss  # noqa: E402
from repro_torch.train.train_step import TrainState  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": {"data": 16, "model": 16}, "2x2": {"data": 2, "model": 2}}
# (mesh, strategy): the production axes and a small fsdp mesh
AXES = (("16x16", "2d"), ("2x2", "fsdp"))


def _stand_ins(mesh: str):
    shape = MESHES[mesh]
    n = 1
    for v in shape.values():
        n *= v
    ref = types.SimpleNamespace(axis_names=tuple(shape), shape=shape)
    port = types.SimpleNamespace(
        mesh_dim_names=tuple(shape),
        mesh=types.SimpleNamespace(shape=tuple(shape.values()), numel=lambda: n))
    return port, ref


def _axes(mesh: str, strategy: str):
    port, ref = _stand_ins(mesh)
    return sh.axes_for_mesh(port, strategy), jsh.axes_for_mesh(ref, strategy)


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


def _shapes(tree):
    """Argument trees of either package as (shape, dtype name) leaves; a
    port model as the reference's stacked tree, a TrainState as its
    three fields."""
    if isinstance(tree, torch.nn.Module):
        return _shapes(convert.stacked_tree(tree))
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):  # a tensor, SDS or TensorSpec
        return (tuple(tree.shape), _dtype(tree.dtype))
    if hasattr(tree, "params") and hasattr(tree, "opt"):
        return ("state", _shapes(tree.params), _shapes(tree.opt), _shapes(tree.step))
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shapes(v) for v in tree)
    raise TypeError(type(tree))


def _specs(tree):
    if isinstance(tree, (JP, sh.P)):
        return ("P", tuple(tree))
    if isinstance(tree, TrainState) or type(tree).__name__ == "TrainState":
        return ("state", _specs(tree.params), _specs(tree.opt), _specs(tree.step))
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_specs(v) for v in tree)
    raise TypeError(type(tree))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_and_model_flops_match_reference(arch):
    cfg, cfg_j = get_config(arch), jax_get_config(arch)
    api, api_j = get_model(cfg), jax_get_model(cfg_j)
    n = specs.param_count(cfg, api)
    assert n == jspecs.param_count(cfg_j, api_j)
    for sub in ("embed", "enc", "layers"):
        assert specs.param_count(cfg, api, sub) == jspecs.param_count(cfg_j, api_j, sub)
    assert specs.expert_params(cfg) == jspecs.expert_params(cfg_j)
    assert specs.active_params(cfg, n) == jspecs.active_params(cfg_j, n)
    for name, cell in SHAPES.items():
        assert specs.model_flops(cfg, api, cell) == jspecs.model_flops(cfg_j, api_j, cell), name
        assert specs._attn_decode_flops(cfg, cell.global_batch, cell.seq_len) == \
            jspecs._attn_decode_flops(cfg_j, cell.global_batch, cell.seq_len)


@pytest.mark.parametrize("mesh,strategy", AXES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch, shape, mesh, strategy):
    cfg, cfg_j = get_config(arch), jax_get_config(arch)
    api, api_j = get_model(cfg), jax_get_model(cfg_j)
    ax, ax_j = _axes(mesh, strategy)
    cell = specs.input_specs(cfg, SHAPES[shape], api, ax)
    ref = jspecs.input_specs(cfg_j, SHAPES[shape], api_j, ax_j)
    assert (cell.kind, cell.meta, cell.model_flops) == (ref.kind, ref.meta, ref.model_flops)
    assert len(cell.args) == len(ref.args)
    for got, want in zip(cell.args, ref.args):
        assert _shapes(got) == _shapes(want)
    assert _specs(cell.in_specs) == _specs(ref.in_specs)
    # every parameter lies on meta: no allocation
    params = cell.args[0].params if cell.kind == "train" else cell.args[0]
    assert {p.device.type for p in params.parameters()} == {"meta"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_input_shapes_match_reference(arch):
    cfg, cfg_j = get_config(arch), jax_get_config(arch)
    for b, cache_len in ((128, 32768), (1, 524288), (3, 7)):
        got = ss.decode_input_shapes(cfg, b, cache_len, get_model(cfg))
        want = jss.decode_input_shapes(cfg_j, b, cache_len, jax_get_model(cfg_j))
        assert _shapes(got[0]) == _shapes(want[0])
        assert [(tuple(t.shape), _dtype(t.dtype)) for t in got[1:]] == \
            [(tuple(t.shape), _dtype(t.dtype)) for t in want[1:]]


_REF_STRATEGIES = r"""
import json
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
mesh = make_production_mesh()
assert mesh.devices.size == 256, mesh.devices.shape
print(json.dumps({a + "." + s: dryrun.pick_strategy(get_config(a), SHAPES[s], mesh)
                  for a in ARCH_IDS for s in SHAPES}))
"""


def test_pick_strategy_matches_reference():
    """At the reference's budget (14e9, a 16 GB v5e) on the production
    16 x 16 mesh: the same strategy for every cell (the reference on 256
    placeholder XLA devices in a subprocess)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=256"}
    r = subprocess.run([sys.executable, "-c", _REF_STRATEGIES], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    port_mesh, _ = _stand_ins("16x16")
    got = {f"{a}.{s}": dryrun.pick_strategy(get_config(a), SHAPES[s], port_mesh,
                                            hbm_budget=14e9)
           for a in ARCH_IDS for s in SHAPES}
    assert got == want
    assert set(want.values()) > {"2d"}  # the grid takes more than the default
    # the H100's budget is the default and picks no fewer sharded-state cells
    assert dryrun.HBM_BUDGET > 14e9


def test_selective_scan_meta_branch_launches_nothing(monkeypatch):
    """K8 on ``meta`` operands: outputs of the right shapes on meta, no
    launch, no plain loop; ``meta_hook`` gets the bytes of the bound
    column (da, dbu, cm and h0 read, y and h_last written)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ssk

    calls = []
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append("launch"))
    monkeypatch.setattr(ssk, "selective_scan_plain", lambda *a: calls.append("plain"))
    seen = []
    monkeypatch.setattr(ssk, "meta_hook", seen.append)
    b, s, d, n = 2, 4096, 8192, 16
    meta = dict(dtype=torch.float32, device="meta")
    da, dbu = torch.empty((b, s, d, n), **meta), torch.empty((b, s, d, n), **meta)
    cm, h0 = torch.empty((b, s, n), **meta), torch.empty((b, d, n), **meta)
    y, h = ssk.selective_scan(da, dbu, cm, h0=h0, return_state=True)
    assert (y.device.type, tuple(y.shape), tuple(h.shape)) == ("meta", (b, s, d), (b, d, n))
    y = ssk.selective_scan(da, dbu, cm)
    assert tuple(y.shape) == (b, s, d) and not calls
    assert seen == [4 * (2 * b * s * d * n + b * s * n + b * s * d + 2 * b * d * n),
                    4 * (2 * b * s * d * n + b * s * n + b * s * d)]
    with pytest.raises(ValueError, match="cm must be"):
        ssk.selective_scan(da, dbu, torch.empty((b, s, n + 1), **meta))


def test_dry_run_of_a_cell_traces_k8_on_meta(monkeypatch):
    """A world of 1 (no mesh): the reduced falcon-mamba prefill traced on
    meta tensors counts K8's bytes and launches no kernel; the argument
    bytes are the parameters' and the tokens'."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "launch", lambda *a: pytest.fail("launched"))
    cfg = get_config("falcon_mamba_7b").reduced(num_layers=2)
    rec = dryrun.run_cell("falcon_mamba_7b", ShapeCell("p", 64, 2, "prefill"), None, "1",
                          None, verbose=False, cfg=cfg)
    n = specs.param_count(cfg, get_model(cfg))
    params = get_model(cfg).init(cfg, None, device="meta")
    p_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    assert n == sum(p.numel() for p in params.parameters())
    assert rec["arg_bytes_per_chip"] == p_bytes + 2 * 64 * 4
    c = fit_chunk(64, cfg.scan_chunk)
    di, n_ = cfg.d_inner, cfg.ssm_state
    assert rec["k8_bytes"] == 64 // c * cfg.num_layers * 4 * (
        2 * 2 * c * di * n_ + 2 * c * n_ + 2 * c * di + 2 * 2 * di * n_)
    assert rec["flops_per_chip"] > 0 and rec["peak_mem_bytes"] > rec["arg_bytes_per_chip"]
