"""The int8 second moment on a mesh (``OptConfig(quantize_v=True)`` with
DTensor state) on a 2 x 2 mesh of 4 gloo ranks (CPU), one subprocess
for the file (``torch_mesh_cases.run_ranks(..., quantize=True)``);
reduced qwen2 and falcon-mamba at 2 layers from the JAX package's
``init_lm`` weights in f32.

* one train step on the mesh (the default clip norm) against the
  single-device step: ``hold_train_step``'s loss, gradient and parameter
  tolerances;
* two steps of the donated ``adamw_update_`` on the mesh (p and m
  sharded, the (q, scale) leaves replicated) against the port's pure
  ``adamw_update`` on the gathered gradients, state and parameters: p,
  m, q and scale bit-equal, and q and scale the same bytes on every
  rank. The clip norm is set out of reach so that the clip scale is 1
  exactly (the global norm is the one value the mesh reduces in another
  order);
* the second step's inputs through the JAX package's ``adamw_update``
  run op by op, as tests/test_torch_optimizer.py's ``eager`` regime
  runs it: q and scale bit-equal, p and m within 1e-6 of each leaf's
  max |ref| (the frameworks round ``b ** count`` on their own);
* ``Trainer(mesh=...)``'s CORE save at step 2 equal byte for byte to a
  single-device Trainer's save of the same state, restored after two
  node failures bit-equal (the int8 leaves included), resumed to step 3;
* the launcher with ``--mesh 2x2 --devices 4 --quantize-v --device cpu``.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_cases as M  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402

ARCHS = ("qwen2_72b", "falcon_mamba_7b")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return M.run_ranks(tmp_path_factory.mktemp("mesh4q"), ARCHS, ckpt=True, quantize=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_train_step_matches_single_device(ranks, arch):
    M.hold_train_step(ranks["train"][arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_int8_update_is_the_pure_one_bit_for_bit(ranks, arch):
    r = ranks["quant"][arch]
    assert r["v_placements"] == ["(Replicate(), Replicate())"], r["v_placements"]
    for step, bits in enumerate(r["bits"]):
        assert all(bits.values()), (step, bits)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_int8_update_matches_the_reference(ranks, arch):
    r = ranks["quant"][arch]
    inp, got = r["jax_inputs"], r["got"]
    jc = jopt.OptConfig(lr=inp["lr"], warmup_steps=1, decay_steps=10, quantize_v=True,
                        clip_norm=inp["clip_norm"])
    as_jax = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    want_p, want_s, metrics = jopt.adamw_update(as_jax(inp["grads"]), as_jax(inp["state"]),
                                                as_jax(inp["params"]), jc)
    assert float(metrics["grad_norm"]) < jc.clip_norm
    is_v = lambda x: isinstance(x, tuple)  # noqa: E731
    for q_s, want in zip(jax.tree.leaves(got["state"]["v"], is_leaf=is_v),
                         jax.tree.leaves(want_s["v"], is_leaf=is_v), strict=True):
        for a, b in zip(q_s, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    for tree, want in ((got["params"], want_p), (got["state"]["m"], want_s["m"])):
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want), strict=True):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * max(np.abs(b).max(), 1e-30))


def test_quantized_core_save_on_a_mesh(ranks):
    r = ranks["ckpt"]
    assert r["save_equal"], r
    assert r["equal"] and r["int8_leaves"] > 5, r
    assert r["restored_step"] == 2 and r["resumed_step"] == 3, r
    assert len(r["losses"]) == 3 and all(np.isfinite(r["losses"])), r


def test_launcher_trains_int8_v_on_a_mesh():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2_72b", "--reduced",
         "--steps", "3", "--devices", "4", "--mesh", "2x2", "--seq-len", "32",
         "--global-batch", "4", "--ckpt-every", "2", "--quantize-v", "--device", "cpu"],
        capture_output=True, text=True, cwd=M.ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(M.ROOT / "src"), OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1].startswith("done at step 3; final loss ")
