"""Serving, and the encdec train step, on a 2 x 2 mesh of 4 gloo ranks
(CPU), one subprocess for the file (``torch_mesh_cases.run_ranks``).

* One id a family (falcon-mamba, qwen2, olmoe, recurrentgemma,
  seamless), 2 layers (the hybrid 3), f32 weights from the JAX package's
  ``init_lm``: the prefill of 4 x 16 tokens (cache length 32) and two
  greedy decodes with the parameters, the batch, the token and the
  caches as DTensors (``make_serve_plan``'s layout), held two ways.
  Against the same calls on one device, each call on the mesh given the
  unsharded run's inputs: the logits within 1e-5 of max |ref|, the f32
  cache leaves within 1e-5 of theirs, the prefill's bf16 cache leaves
  (the dense and window caches are bf16 whatever the compute dtype)
  within 1e-5 of their max |ref| and one bf16 spacing of each element
  (the rounding of a value within the f32 tolerance: an f32 sum in
  another order may round to the neighbour). Against the JAX package's
  prefill and decodes on the same weights, batch and tokens, at the
  single-device twins' tolerance (tests/test_torch_models.py): every
  logits and cache element within rtol = atol = 1e-4, but for one-ulp
  neighbours in at most one element in a thousand of a bf16 leaf. The
  decodes run in f32 from the reference's prefill cache cast to f32 and
  take the greedy tokens of the reference's logits, as the twins' do, so
  the token's k and v are written unrounded.
* seamless's train step as tests/test_torch_mesh_families.py holds the
  other ids, but for one stated leaf: the encoder's ``ln1`` gradients.
  ``encode`` casts the frames to bf16, as the reference does, so the
  first encoder layer's norm writes a bf16 output, and its gradient
  comes back in bf16: each element carries one bf16 rounding (2^-8
  relative) that falls on either side when the sharded and unsharded
  sums differ in their last f32 bits. The leaf is held within 2^-7 (two
  roundings) of its max |ref|; every other leaf at the slice's 1e-4.
"""

from __future__ import annotations

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import torch_mesh_cases as M  # noqa: E402

SERVE = ("falcon_mamba_7b", "qwen2_72b", "olmoe_1b_7b", "recurrentgemma_9b",
         "seamless_m4t_large_v2")
BF16_LEAF = "enc.0.ln1."  # the encoder's first layer norm (its scale and bias)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return M.run_ranks(tmp_path_factory.mktemp("mesh4"), ("seamless_m4t_large_v2",),
                       serve=SERVE)


@pytest.mark.parametrize("arch", SERVE)
def test_prefill_and_decodes_on_a_mesh_match_single_device(ranks, arch):
    r = ranks["serve"][arch]
    assert r["finite"] and len(r["logits_rel"]) == 3, r
    assert max(r["logits_rel"]) <= 1e-5, r
    assert r["cache_f32_rel"] <= 1e-5, r
    assert r["cache_bf16_ulps"] <= 1.0, r
    assert r["jax_bad"] == 0 and r["jax_flip_share"] <= M.FLIP_SHARE, r


def test_encdec_train_step_on_a_mesh(ranks):
    r = ranks["train"]["seamless_m4t_large_v2"]
    by_leaf = r.pop("grad_rel_by_leaf")
    bf16 = {k: v for k, v in by_leaf.items() if k.startswith(BF16_LEAF)}
    assert bf16 and max(bf16.values()) <= 2.0 ** -7, bf16
    r["grad_rel"] = max(v for k, v in by_leaf.items() if not k.startswith(BF16_LEAF))
    M.hold_train_step(r)
