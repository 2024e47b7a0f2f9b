"""The port's ``lm_loss`` and its gradients against the JAX package's:
the loss half of tests/test_models.py's ``test_arch_smoke_loss``,
comparing values where the reference checks finiteness, for the ids
whose loss takes the plain path (an untied head, no prefix, per-layer
remat): falcon-mamba (ssm), qwen2, mistral-large, starcoder2,
olmoe (moe: the loss adds 0.01 x the layers' mean load-balance aux, and
the gradients reach the router through the gates and the aux) and
recurrentgemma (hybrid: one (rec, rec, attn) group under remat, then
its unstacked rec tail; the RG-LRU trained through the associative
scan) at ``reduced()``. The tied head, the vlm prefix and the two-level remat
are in tests/test_torch_loss_paths.py; prefill and decode in
tests/test_torch_models.py.

The JAX package's ``init`` weights cast to float32, carried across by
``models.convert.from_jax``; batch 2 x 64 tokens. Tolerances, set from
float32 before the runs: the loss within rtol = atol = 1e-4, each
gradient leaf within 1e-3 of its max |ref| (only the order of float32
sums differs).
"""

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
import torch_model_cases as C  # noqa: E402

CASES = ("falcon_mamba_7b", "qwen2_72b", "mistral_large_123b", "starcoder2_15b", "olmoe_1b_7b",
         "recurrentgemma_9b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    return {case: C.loss_and_grads(case) for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_loss_matches_jax(case, runs):
    C.assert_loss_matches(runs[case])


@pytest.mark.parametrize("case", CASES)
def test_every_gradient_leaf_matches_jax(case, runs):
    C.assert_every_gradient_leaf_matches(runs[case])
