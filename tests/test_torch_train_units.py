"""The port's training units against the JAX package's: the elastic
runtime (``repro_torch.train.elastic``) on tests/test_train_serve.py's
cases, the data pipeline (``batch_at`` equal bit for bit to the
reference's for hypothesis-drawn (seed, step), the vlm and encdec stub
branches included; ``device_batch``; ``shapes_for_cell``), and the
training launcher in a subprocess on the CPU (falcon-mamba, qwen2,
olmoe, recurrentgemma and seamless-m4t). The train step, the loop
and its checkpoints are in tests/test_torch_train.py.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as JPipeline  # noqa: E402
from repro.data.pipeline import shapes_for_cell as jax_shapes_for_cell  # noqa: E402
from repro.train import elastic as jelastic  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig, ShapeCell  # noqa: E402
from repro_torch.data.pipeline import SyntheticPipeline, shapes_for_cell  # noqa: E402
from repro_torch.train import elastic  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = get_config("falcon_mamba_7b").reduced(num_layers=2)


def _bits(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        return leaf.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(leaf).tobytes()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "qwen2_72b", "olmoe_1b_7b",
                                  "recurrentgemma_9b", "seamless_m4t_large_v2"])
def test_launcher_trains_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--device", "cpu", "--steps", "3", "--seq-len", "32",
         "--global-batch", "2", "--ckpt-every", "2"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1].startswith("done at step 3; final loss ")
    assert sum("ckpt @" in line for line in lines) == 2


@pytest.mark.parametrize("flags,error", [
    (["--mesh", "2x2", "--devices", "3"], ValueError),
])
def test_launcher_mesh_waits_for_its_slice(flags, error):
    """Its slice has come (tests/test_torch_launch_integration.py trains
    on a 2 x 2 mesh, tests/test_torch_mesh_quantize.py with
    ``--quantize-v``); what the launcher refuses before it spawns a rank:
    a rank count other than the mesh's size."""
    from repro_torch.launch import train

    with pytest.raises(error):
        train.main(["--arch", "falcon_mamba_7b", "--reduced", "--device", "cpu", *flags])


# ---------------------------------------------------------------------------
# elastic units: the reference's cases, on both packages
# ---------------------------------------------------------------------------


def _monitor_case(mod):
    m = mod.HostMonitor(timeout_s=10, straggler_factor=2.0)
    for step in range(5):
        for h in ("h0", "h1", "h2", "h3"):
            m.beat(h, step, 1.0 if h != "h3" else 3.5, now=float(step))
    before = m.stragglers()
    m.beat("h0", 5, 1.0, now=100.0)
    return before, m.dead_hosts(now=100.0)


def _plan_case(mod):
    plan = mod.ElasticPlan(hosts=[0, 1, 2, 3], spares=[7, 8])
    replaced = plan.replace(2)
    hosts = list(plan.hosts)
    released = plan.shrink_to(2)
    perm = mod.device_permutation(8, plan, devices_per_host=4)
    return replaced, hosts, released, plan.hosts, plan.remaps, perm.tolist()


def _shrink_case(mod):
    return [mod.shrink_mesh_shape(dp, f) for dp in (1, 2, 8, 12, 16) for f in range(dp)]


@pytest.mark.parametrize("case", [_monitor_case, _plan_case, _shrink_case])
def test_elastic_units_match_reference(case):
    assert case(elastic) == case(jelastic)


def test_elastic_reference_values():
    assert _monitor_case(elastic) == (["h3"], ["h1", "h2", "h3"])
    assert _plan_case(elastic)[:4] == ((2, 7), [0, 1, 7, 3], [7, 3], [0, 1])
    assert elastic.shrink_mesh_shape(16, 3) == 8 and elastic.shrink_mesh_shape(16, 1) == 8
    with pytest.raises(IndexError):
        elastic.ElasticPlan(hosts=[0], spares=[]).replace(0)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


def _port_cfg(jcfg) -> ArchConfig:
    """A reference config's fields in the port's schema."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name != "core_code"}
    return ArchConfig(**kw)


STUB_ARCHS = ("pixtral_12b", "seamless_m4t_large_v2")


@settings(max_examples=25, deadline=None)
@given(step=st.integers(0, 10_000), seed=st.integers(0, 5),
       arch=st.sampled_from(("falcon_mamba_7b", "olmoe_1b_7b", *STUB_ARCHS)))
def test_batch_at_equals_reference(step, seed, arch):
    jcfg = jax_get_config(arch).reduced()
    ref = JPipeline(jcfg, seq_len=16, global_batch=2, seed=seed).batch_at(step)
    got = SyntheticPipeline(_port_cfg(jcfg), seq_len=16, global_batch=2, seed=seed).batch_at(step)
    assert list(got) == list(ref)
    for key, r in ref.items():
        g = got[key]
        if key in ("tokens", "labels"):
            assert g.dtype == r.dtype == np.int32
            np.testing.assert_array_equal(g, r)
        else:  # the stub embeddings: bfloat16, compared as bits
            assert g.dtype == torch.bfloat16 and str(r.dtype) == "bfloat16"
            assert tuple(g.shape) == r.shape and _bits(g) == _bits(r)


def test_device_batch_and_cell_shapes():
    p = SyntheticPipeline(CFG, seq_len=16, global_batch=2, seed=3)
    dev = p.device_batch(4, "cpu")
    host = p.batch_at(4)
    assert set(dev) == {"tokens", "labels"}
    for k, v in dev.items():
        assert v.device.type == "cpu" and v.dtype == torch.int32
        np.testing.assert_array_equal(v.numpy(), host[k])
    for arch in ("falcon_mamba_7b", *STUB_ARCHS):
        jcfg = jax_get_config(arch).reduced()
        for kind in ("train", "prefill"):
            cell = ShapeCell("c", 64, 4, kind)
            ref = jax_shapes_for_cell(jcfg, cell)
            got = shapes_for_cell(_port_cfg(jcfg), cell)
            port = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                    for k, v in got.items()}
            assert port == {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()}
