"""The sharded train step of tests/test_torch_mesh_train.py on the other
ids that train on a 2 x 2 mesh: the dense ids mistral, command-r and
starcoder2 (layernorm, the gelu MLP, a window), pixtral (the vlm
prefix), recurrentgemma (the hybrid's rec blocks and window attention;
3 layers, one group), and the moe ids olmoe and granite (routing,
dispatch and combine on each batch shard, the experts on the tp axis;
and granite with 3 experts, which tp = 2 does not divide, so each
expert's hidden dim is on tp).
Same ranks, same tolerances. seamless trains on the mesh in
tests/test_torch_mesh_serve.py, with its one stated bf16 leaf."""

from __future__ import annotations

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import torch_mesh_cases as M  # noqa: E402

ARCHS = ("mistral_large_123b", "command_r_35b", "starcoder2_15b", "pixtral_12b",
         "recurrentgemma_9b", "olmoe_1b_7b", "granite_moe_3b_a800m", "granite_moe_3b_a800m@ff")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return M.run_ranks(tmp_path_factory.mktemp("mesh4"), ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_single_device(ranks, arch):
    M.hold_train_step(ranks["train"][arch])
