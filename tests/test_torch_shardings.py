"""Spec twins: the port's sharding specs (trees of ``shardings.P``) equal
the JAX package's PartitionSpec trees leaf for leaf, for every id at
``reduced()`` and each strategy's ``MeshAxes`` on a (2, 2) mesh (and a
(2, 2, 2) pod mesh): ``specs``, ``cache_specs``, ``state_specs``,
``opt_specs`` and ``batch_specs``. Both ``MeshAxes`` are built from mesh
shapes alone, so no mesh of 4 devices is needed. Then ``make_serve_plan``
over a grid, ``placements`` on one- and two-axis entries, and each
parameter's spec against its rank."""

from __future__ import annotations

import dataclasses
import types

import pytest

jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import shardings as jsh  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import shardings as sh  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

MESHES = {"2x2": {"data": 2, "model": 2}, "2x2x2": {"pod": 2, "data": 2, "model": 2}}
STRATEGIES = ("2d", "fsdp", "tp_only")


def _axes(mesh: str, strategy: str):
    """Both packages' MeshAxes from stand-ins that carry only a mesh's
    names and shape (what ``axes_for_mesh`` reads of each)."""
    shape = MESHES[mesh]
    ref_mesh = types.SimpleNamespace(axis_names=tuple(shape), shape=shape)
    port_mesh = types.SimpleNamespace(mesh_dim_names=tuple(shape),
                                      mesh=types.SimpleNamespace(shape=tuple(shape.values())))
    ref = jsh.axes_for_mesh(ref_mesh, strategy)
    port = sh.axes_for_mesh(port_mesh, strategy)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    return port, ref


def _norm(tree):
    """Spec trees of either package in one comparable form: a spec as
    ("P", its entries), dicts, lists and tuples kept."""
    if isinstance(tree, (JP, sh.P)):
        return ("P", tuple(tree))
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_norm(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_norm(v) for v in tree)
    raise TypeError(type(tree))


def _plans(cfg, cfg_j, port_ax, ref_ax):
    for batch, cache_len in ((4, 64), (1, 64), (2, 6), (3, 64)):
        plan = sh.make_serve_plan(cfg, port_ax, batch, cache_len)
        ref = jsh.make_serve_plan(cfg_j, ref_ax, batch, cache_len)
        assert dataclasses.asdict(plan) == dataclasses.asdict(ref)
        yield batch, plan, ref


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_match_reference(arch, strategy, mesh):
    cfg, cfg_j = get_config(arch).reduced(), jax_get_config(arch).reduced()
    api, api_j = get_model(cfg), jax_get_model(cfg_j)
    ax, ax_j = _axes(mesh, strategy)
    assert _norm(api.specs(cfg, ax)) == _norm(api_j.specs(cfg_j, ax_j))
    for batch, plan, plan_j in _plans(cfg, cfg_j, ax, ax_j):
        assert _norm(api.cache_specs(cfg, ax, batch, plan)) == _norm(
            api_j.cache_specs(cfg_j, ax_j, batch, plan_j)), (batch, plan)
    for quantize_v in (False, True):
        oc, oc_j = opt.OptConfig(quantize_v=quantize_v), jopt.OptConfig(quantize_v=quantize_v)
        st, st_j = ts.state_specs(cfg, api, ax, oc), jts.state_specs(cfg_j, api_j, ax_j, oc_j)
        assert _norm(st.params) == _norm(st_j.params)
        assert _norm(st.opt) == _norm(st_j.opt)
        assert _norm(st.step) == _norm(st_j.step) == ("P", ())
        assert _norm(opt.opt_specs(st.params, oc)) == _norm(jopt.opt_specs(st_j.params, oc_j))
    for with_stub in (True, False):
        assert _norm(pipeline.batch_specs(cfg, ax, with_stub=with_stub)) == _norm(
            jpipe.batch_specs(cfg_j, ax_j, with_stub=with_stub))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_parameter_has_a_spec_of_its_rank(arch, strategy):
    """``convert.param_specs`` gives each parameter of the port's model
    (built on ``meta``) its stacked leaf's spec without the layer entry,
    no longer than the parameter's rank, on axes that divide it."""
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    ax, _ = _axes("2x2", strategy)
    model = api.init(cfg, None, device="meta")
    specs = convert.param_specs(model, api.specs(cfg, ax))
    params = dict(model.named_parameters())
    assert sorted(specs) == sorted(params)
    sizes = MESHES["2x2"]
    for name, spec in specs.items():
        assert isinstance(spec, sh.P) and len(spec) <= params[name].dim(), name
        for dim, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                assert a is None or params[name].shape[dim] % sizes[a] == 0, (name, spec)


def test_state_shape_is_the_state_on_meta():
    cfg = get_config("qwen2_72b").reduced()
    api = get_model(cfg)
    oc = opt.OptConfig(quantize_v=True)
    shape = ts.state_shape(cfg, api, oc)
    real = ts.init_state(cfg, api, 0, oc, device="cpu")
    assert all(p.device.type == "meta" for p in shape.params.parameters())

    def flat(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in flat(v)]
        return [(tuple(tree.shape), tree.dtype)]

    assert flat(shape.opt) == flat(real.opt)
    assert [(p.shape, p.dtype) for p in shape.params.parameters()] == [
        (p.shape, p.dtype) for p in real.params.parameters()]
    assert shape.step.shape == () and shape.step.dtype == real.step.dtype


@pytest.mark.parametrize("kv", [0, 1, 2, 4, 6, 8])
@pytest.mark.parametrize("strategy", STRATEGIES + ("single",))
def test_make_serve_plan_grid(kv, strategy):
    cfg = types.SimpleNamespace(num_kv_heads=kv)
    if strategy == "single":
        ax, ax_j = sh.SINGLE, jsh.SINGLE
    else:
        ax, ax_j = _axes("2x2", strategy)
    for batch in (1, 2, 3, 4, 8):
        for cache_len in (0, 6, 64, 100):
            got = sh.make_serve_plan(cfg, ax, batch, cache_len)
            want = jsh.make_serve_plan(cfg, ax_j, batch, cache_len)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (batch, cache_len)


def test_mesh_axes_helpers_match_reference():
    for mesh in MESHES:
        for strategy in STRATEGIES:
            ax, ax_j = _axes(mesh, strategy)
            assert ax.all_seq == ax_j.all_seq and ax.all_seq_size == ax_j.all_seq_size
            for dim in (1, 2, 3, 4, 6, 8, 12):
                assert ax.tp_divides(dim) == ax_j.tp_divides(dim)
                assert ax.fsdp_divides(dim) == ax_j.fsdp_divides(dim)
                assert ax.tp_if(dim) == ax_j.tp_if(dim)
                assert ax.fsdp_if(dim) == ax_j.fsdp_if(dim)


@pytest.mark.parametrize("entries", [
    (), (None,), ("data",), (("data",), None), ((), "model"), (("data", "model"), None),
    (("pod", "data"), None, "model"), (None, ("data", "model"), None),
])
def test_p_normalises_as_jax(entries):
    assert tuple(sh.P(*entries)) == tuple(JP(*entries))


def test_placements_single_and_two_axis_entries():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    cases = {
        sh.P(): (Replicate(), Replicate()),
        sh.P("data", None): (Shard(0), Replicate()),
        sh.P(None, "model"): (Replicate(), Shard(1)),
        sh.P("model", "data"): (Shard(1), Shard(0)),
        sh.P(("data", "model"), None): (Shard(0), Shard(0)),
        sh.P(None, None, ("data", "model")): (Shard(2), Shard(2)),
    }
    for spec, want in cases.items():
        assert sh.placements(spec, mesh) == want, spec
    pod = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sh.placements(sh.P(("pod", "data"), None, "model"), pod) == (
        Shard(0), Shard(0), Shard(2))
    for bad, match in ((sh.P(("model", "data")), "mesh-dim order"),
                       (sh.P("data", "data"), "named twice"),
                       (sh.P("pod"), "not one of")):
        with pytest.raises(ValueError, match=match):
            sh.placements(bad, mesh)


def test_constrain_is_the_identity_on_a_plain_tensor():
    import torch

    x = torch.arange(6.0).reshape(2, 3)
    assert sh.constrain(x, sh.P("data", "model")) is x
    assert not sh.has_mesh()
