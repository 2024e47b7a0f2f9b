"""The sharded train step of tests/test_torch_mesh_train.py on the other
ids that train on a 2 x 2 mesh with no code of their own: the dense ids
mistral, command-r and starcoder2 (layernorm, the gelu MLP, a window),
pixtral (the vlm prefix) and recurrentgemma (the hybrid's rec blocks and
window attention; 3 layers, one group). Same ranks, same tolerances.
The moe ids and seamless wait (ROADMAP queue 1)."""

from __future__ import annotations

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import torch_mesh_cases as M  # noqa: E402

ARCHS = ("mistral_large_123b", "command_r_35b", "starcoder2_15b", "pixtral_12b",
         "recurrentgemma_9b")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return M.run_ranks(tmp_path_factory.mktemp("mesh4"), ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_single_device(ranks, arch):
    M.hold_train_step(ranks["train"][arch])
