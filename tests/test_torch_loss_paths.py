"""The port's ``lm_loss`` and its gradients against the JAX package's
on the loss's special paths: command-r's tied embedding (the (V, d)
``embed`` applied transposed as the head), pixtral's patch-embedding
prefix (its positions run through the layers and take no loss),
mistral-large at ``reduced(num_layers=8, remat_block=2)``, whose layers
take the two-level remat (four blocks of two), granite-moe's tied
embedding under the moe loss's own fold (the aux carried through it),
and seamless-m4t's encoder memory (the decoder's cross-attention over
the encoded ``src_embed`` frames, gradients reaching the encoder
through it; the float32 reference as tests/torch_model_cases.py
composes it). The plain path is in
tests/test_torch_model_grads.py, with the same weights, batch and
tolerances: the loss within rtol = atol = 1e-4, each gradient leaf
within 1e-3 of its max |ref|. The two-level remat's loss and gradients
also equal the per-layer remat's, bit for bit.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch_model_cases as C  # noqa: E402

from repro_torch.models import convert  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.models.shardings import SINGLE  # noqa: E402

CASES = ("command_r_35b", "pixtral_12b", "mistral_large_123b/8L-block2", "granite_moe_3b_a800m",
         "seamless_m4t_large_v2")


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


def test_tied_and_prefix_cases_take_their_paths():
    tied, _ = C.cfgs("command_r_35b")
    vlm, _ = C.cfgs("pixtral_12b")
    tied_moe, _ = C.cfgs("granite_moe_3b_a800m")
    encdec, _ = C.cfgs("seamless_m4t_large_v2")
    assert tied.tie_embeddings and vlm.family == "vlm" and vlm.num_stub_tokens == 8
    assert tied_moe.tie_embeddings and tied_moe.family == "moe"
    assert "patch_embed" in C.batch(vlm)[0]
    assert encdec.family == "encdec" and C.batch(encdec)[0]["src_embed"].shape == (C.B, 8, 128)
    assert C.cfgs("mistral_large_123b/8L-block2")[0].remat_block == 2


def test_two_level_remat_gradients_equal_per_layer_ones():
    """mistral at 8 layers: ``remat_block=2`` (four blocks of two) and
    ``remat_block=0`` give the same loss and gradients, bit for bit."""
    case = "mistral_large_123b/8L-block2"
    out = []
    for block in (2, 0):
        cfg = dataclasses.replace(C.cfgs(case)[0], remat_block=block)
        model = convert.from_jax(jax.tree.map(np.asarray, C.ref_params(case, "float32")), cfg,
                                 device="cpu", trainable=True)
        loss = get_model(cfg).loss(model, C.batch(cfg)[0], cfg, SINGLE)
        out.append((loss.detach(), torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1], strict=True))
