"""The port's model families against the JAX package's: the twin of
tests/test_models.py, comparing values where the reference checks
shapes and finiteness.

Every id (the ssm falcon-mamba, the dense / vlm qwen2, mistral-large,
starcoder2, command-r and pixtral, the moe olmoe and granite-moe, the
hybrid recurrentgemma and the encdec seamless-m4t) at ``reduced()``,
with the JAX package's ``init`` weights carried across by
``models.convert.from_jax``; batch 2, prompt 64, cache 128, for pixtral
an 8-token ``patch_embed`` prefix and for seamless 8 encoder frames
(``src_embed``). The caches are compared leaf by leaf over their trees
(the hybrid's nests ``groups`` and a ``tail`` list). The encdec
reference runs in float32 as tests/torch_model_cases.py says: its own
``encode`` raises there. Tolerances, set from the dtypes before the
runs:

- float32 (the weights cast in both packages): the prefill logits
  within rtol = atol = 1e-4. The dense cache is bf16 whatever the compute
  dtype, so a k or v within float32 rounding of the reference's can
  round to the neighbouring bf16 value: the prefill caches are held to
  rtol = atol = 1e-4 except for such one-ulp neighbours, at most one
  element in a thousand (measured: 12 to 21 of 65,536). Decode then runs
  from the reference's prefill cache cast to float32, in both packages,
  so that every step of it is float32 (from the bf16 cache the
  reference rounds the softmax weights and the value product to bf16,
  and a float32-sized difference upstream flips those roundings); the
  two steps' logits and caches within rtol = atol = 1e-4.
- bfloat16 (the reference's own dtypes), prefill and two decode steps
  each from its own package's cache: max |port - ref| <= 2e-2 * max
  |ref| for every compared tensor of the dense and vlm ids, as in
  tests/test_torch_mamba.py (the frameworks round bf16 at other places;
  measured up to 1.78e-2, qwen2's second decode logits). The ssm id
  drifts further on these prompts, its f32 SSM state carried from bf16
  activations (measured up to 3.11e-2, the second decode's state; its
  own twin holds 2e-2 on other prompts), and is held to 4e-2, as is the
  hybrid id (its f32 LRU state carried from bf16 activations too). A moe
  layer routes each token to the top k of its bf16 router logits, so
  where the packages' roundings upstream part a near tie a token goes
  to another expert, and every tensor downstream moves by that expert's
  output. Each package's routing is recorded layer by layer and the
  tokens whose expert set differs are counted: at most 5% of a step's
  routed tokens, the first one a near tie (within four bf16 ulps) of
  the port's own logits. Every element such a token can reach by
  causality (``prefill_reach``, ``decode_reach`` in
  tests/torch_model_cases.py: its row's positions from it on, in the
  layers above it, and the logits of its row) must be finite; every
  other element of every logits and cache tensor is held to 2e-2.
  Measured, olmoe and granite alike: 1 token at layer 1 (an exact tie
  in the port's logits, one ulp apart in the reference's) and 4 at
  layer 3 of the prefill's 512 token-layers, none in the decodes; they
  reach one row of the two, from the layer-1 token's position on, in
  cache layers 2-3 and the logits. In float32 no routing may differ.

The reference's ``test_decode_matches_prefill_dense`` runs on both
packages. The loss and gradients of the same ids are in
tests/test_torch_model_grads.py; the cases and checks both files share
are in tests/torch_model_cases.py.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch_model_cases as C  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro.models.shardings import SINGLE as JSINGLE  # noqa: E402
from repro.models.shardings import ServePlan as JServePlan  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.models.shardings import SINGLE  # noqa: E402
from repro_torch.models.stack import tree_paths  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- prefill and decode -------------------------------------------------------


@pytest.fixture(scope="module")
def serve_runs():
    """(arch, dtype) -> {step: (port (logits, cache), ref (logits, cache))}
    for prefill and two decode steps. float32 decodes from the
    reference's prefill cache cast to float32; bfloat16 chains each
    package's own caches."""
    out = {}
    for arch in C.PORTED_IDS:
        cfg, cfg_j = C.cfgs(arch)
        api, api_j = get_model(cfg), jax_get_model(cfg_j)
        batch, jbatch = C.batch(cfg)
        batch.pop("labels"), jbatch.pop("labels")
        for dtype in ("float32", "bfloat16"):
            with C.recorded_routes() as routes, C.reference(cfg_j, dtype) as run:
                jprefill = run(lambda p, b, api_j=api_j, cfg_j=cfg_j:
                               api_j.prefill(p, b, cfg_j, JSINGLE, C.CACHE_LEN))
                jdecode = run(lambda p, t, c, pos, api_j=api_j, cfg_j=cfg_j:
                              api_j.decode(p, t, c, pos, cfg_j, JSINGLE, JServePlan()))
                p = C.ref_params(arch, dtype)
                model = convert.from_jax(jax.tree.map(np.asarray, p), cfg, device="cpu")
                jl, jc = jprefill(p, jbatch)
                pl, pc = api.prefill(model, batch, cfg, SINGLE, C.CACHE_LEN)
                pos = C.S + C.prefix_len(cfg)
                steps = {"prefill": ((pl, pc), (jl, jc))}
                flips = {"prefill": C.route_flips(routes)}
                margins = C.first_flip_margins(routes)
                reach = {"prefill": C.prefill_reach(C.route_flip_mask(routes), cfg.num_layers,
                                                    C.B, pos, C.CACHE_LEN)}
                if dtype == "float32":
                    jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
                    pc = C.to_torch(jc)
                for i in range(2):
                    routes["port"].clear(), routes["ref"].clear()
                    nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
                    jl, jc = jdecode(p, jnp.asarray(nxt), jc, jnp.asarray(pos + i))
                    pl, pc = api.decode(model, torch.from_numpy(nxt), pc, pos + i, cfg, SINGLE,
                                        None)
                    steps[f"decode{i}"] = ((pl, pc), (jl, jc))
                    flips[f"decode{i}"] = C.route_flips(routes)
                    margins = margins or C.first_flip_margins(routes)
                    reach[f"decode{i}"] = C.decode_reach(
                        C.route_flip_mask(routes), reach[list(reach)[-1]][0], pos + i)
            out[arch, dtype] = steps
            out[arch, dtype, "flips"] = flips
            out[arch, dtype, "margins"] = margins
            out[arch, dtype, "reach"] = reach
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", ["prefill", "decode0", "decode1"])
@pytest.mark.parametrize("arch", C.PORTED_IDS)
def test_serve_steps_match_jax(arch, step, dtype, serve_runs):
    (logits, cache), (jlogits, jcache) = serve_runs[arch, dtype][step]
    cfg = C.cfgs(arch)[0]
    assert logits.shape == (C.B, cfg.vocab_size)
    assert str(logits.dtype).removeprefix("torch.") == str(jlogits.dtype)
    cache, jcache = tree_paths(cache), tree_paths(jcache)
    assert set(cache) == set(jcache)
    for name, leaf in cache.items():
        assert str(leaf.dtype).removeprefix("torch.") == str(jcache[name].dtype), name
    flips = serve_runs[arch, dtype, "flips"]
    if dtype == "bfloat16":
        rel = C.BF16_REL[cfg.family]
        # a moe layer routes by the top k of its bf16 router logits: where
        # the two packages' roundings upstream part a near tie, a token
        # goes to another expert and every element that token reaches by
        # causality moves by that expert's output. Those elements are
        # counted, not held; every other one is.
        tokens = C.B * (C.S if step == "prefill" else 1) * cfg.num_layers
        assert sum(flips[step]) <= C.ROUTE_FLIP_SHARE * tokens, flips
        # the first difference is a near tie of the port's own logits
        margins = serve_runs[arch, dtype, "margins"]
        assert all(0 <= m <= C.ROUTE_MARGIN for m in margins), margins
        cache_reach, logits_reach = serve_runs[arch, dtype, "reach"][step]
        C.assert_bf16_close(logits, jlogits, rel, held=~logits_reach)
        for name, leaf in cache.items():
            held = ~cache_reach if cfg.family == "moe" else None
            C.assert_bf16_close(leaf, jcache[name], rel, held=held)
        return
    assert not any(n for s in flips for n in flips[s]), flips
    C.assert_f32_close(logits, jlogits)
    for name, leaf in cache.items():
        C.assert_f32_close(leaf, jcache[name], bf16_leaf=leaf.dtype == torch.bfloat16)


@pytest.mark.parametrize("arch", C.PORTED_IDS)
def test_cache_shape_matches_jax(arch):
    cfg, cfg_j = C.cfgs(arch)
    want = tree_paths(jax_get_model(cfg_j).cache_shape(cfg_j, C.B, C.CACHE_LEN))
    got = tree_paths(get_model(cfg).cache_shape(cfg, C.B, C.CACHE_LEN))
    cache = tree_paths(get_model(cfg).init_cache(cfg, C.B, C.CACHE_LEN, device="cpu"))
    assert set(got) == set(want) == set(cache)
    for k, spec in got.items():
        assert spec.shape == want[k].shape
        assert str(spec.dtype).removeprefix("torch.") == str(want[k].dtype)
        assert cache[k].shape == spec.shape and cache[k].dtype == spec.dtype
        assert not cache[k].any()


def test_decode_matches_prefill_dense():
    """tests/test_models.py's oracle on both packages: teacher-forced
    decode after a 16-token prefill reproduces the 20-token prefill's
    next-token logits (rtol = atol = 0.05), and the two packages' decode
    logits agree (bf16 weights: within 2e-2 of max |ref|)."""
    cfg_j = jconfigs.get_config("qwen2_72b").reduced(num_layers=2)
    cfg = configs.get_config("qwen2_72b").reduced(num_layers=2)
    api_j, api = jax_get_model(cfg_j), get_model(cfg)
    rng = jax.random.PRNGKey(0)
    params = api_j.init(cfg_j, rng)
    model = convert.from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    b, s = 2, 16
    tok = jax.random.randint(rng, (b, s + 4), 0, cfg.vocab_size)
    ttok = torch.from_numpy(np.asarray(tok))
    jprefill = jax.jit(lambda p, t: api_j.prefill(p, {"tokens": t}, cfg_j, JSINGLE, 64))
    jdecode = jax.jit(lambda p, t, c, pos: api_j.decode(p, t, c, pos, cfg_j, JSINGLE,
                                                         JServePlan()))
    _, jcache = jprefill(params, tok[:, :s])
    _, cache = api.prefill(model, {"tokens": ttok[:, :s]}, cfg, SINGLE, 64)
    for i in range(4):
        jld, jcache = jdecode(params, tok[:, s + i : s + i + 1], jcache, jnp.asarray(s + i))
        ld, cache = api.decode(model, ttok[:, s + i : s + i + 1], cache, s + i, cfg, SINGLE,
                               None)
    jlp2, _ = jprefill(params, tok)
    lp2, _ = api.prefill(model, {"tokens": ttok}, cfg, SINGLE, 64)
    np.testing.assert_allclose(C.to_np(jld), C.to_np(jlp2), rtol=0.05, atol=0.05)
    np.testing.assert_allclose(C.to_np(ld), C.to_np(lp2), rtol=0.05, atol=0.05)
    C.assert_bf16_close(ld, jld)
    C.assert_bf16_close(lp2, jlp2)


@pytest.mark.parametrize("arch", C.PORTED_IDS)
def test_config_and_family_are_the_references(arch):
    cfg, cfg_j = C.cfgs(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert dataclasses.asdict(configs.get_config(arch)) == dataclasses.asdict(
        jconfigs.get_config(arch))
    assert get_model(cfg).family == jax_get_model(cfg_j).family
