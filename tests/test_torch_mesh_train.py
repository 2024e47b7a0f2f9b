"""Sharded against unsharded on a 2 x 2 mesh of 4 gloo ranks (CPU).

One subprocess spawns the 4 ranks once for the whole file
(``torch_mesh_cases.run_ranks``); they run only the port (and numpy) and
write their measurements for the tests below, which hold them to the
stated tolerances. Every check starts from the same weights: the JAX
package's ``init_lm`` converted to f32.

* reduced qwen2 (dense) and reduced falcon-mamba (ssm), 2 layers: one
  f32 train step on the mesh (``Trainer.place_state``, the batch by
  ``batch_specs``, the step under ``mesh_context``) against the port's
  single-device step: the loss within 1e-5 relative, every gradient leaf
  within 1e-4 of its max |ref|, the new parameters within 1e-5 of AdamW
  on the sharded run's own gradients and of the single-device step
  wherever |g| >= 1e-6 (AdamW's first step is g / (|g| + 1e-8): near
  eps it turns the gradients' 1e-6 relative difference into up to lr);
* ``Trainer(mesh=...)``'s CORE checkpoint at step 2 (rank 0 stores the
  gathered state), restored after two node failures bit-equal, resumed;
* the sequence-sharded ``attention_decode_general`` (over both mesh axes
  at B = 1, and batch on data with the sequence on model at B = 2)
  against the reference's unsharded function on the same inputs, f32,
  1e-5: the ring wrapped and not, ``sliding_window`` on and off.

tests/test_torch_mesh_families.py runs the same train-step check on the
other ids that train on a mesh.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import torch_mesh_cases as M  # noqa: E402

ARCHS = ("qwen2_72b", "falcon_mamba_7b")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return M.run_ranks(tmp_path_factory.mktemp("mesh4"), ARCHS, ckpt=True, decode=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_single_device(ranks, arch):
    M.hold_train_step(ranks["train"][arch])


def test_core_save_on_a_mesh_restores_bit_equal(ranks):
    r = ranks["ckpt"]
    assert r["equal"] and r["leaves"] > 10, r
    assert r["restored_step"] == 2 and r["resumed_step"] == 3, r
    assert len(r["losses"]) == 3 and all(np.isfinite(r["losses"])), r


@pytest.mark.parametrize("case", range(len(M.DECODE_CASES)),
                         ids=[f"w{w}-b{b}-{p}-pos{pos}" for w, b, p, pos in M.DECODE_CASES])
def test_sequence_sharded_decode_matches_reference(ranks, case):
    r = ranks["decode"][case]
    plan = M.DECODE_CASES[case][2]
    assert r["local_slots"] == M.CACHE_LEN // (4 if plan == "both" else 2), r
    assert r["o"] <= 1e-5 * max(1.0, r["scale"]), r
    # the written k is rotated (RoPE's f32 angles, as the unsharded twins)
    assert r["k"] <= 1e-5 and r["v"] <= 1e-5, r
