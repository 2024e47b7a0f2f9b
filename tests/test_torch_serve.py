"""The port's serving path against the JAX package's: the launcher's
continuous-batching loop, the SlotManager, cache sizing, greedy sampling
and the config registry.

The serve loop runs the reduced falcon-mamba, the reduced starcoder2
(the dense family), and the reduced recurrentgemma (hybrid) and
seamless-m4t (encdec, decoding against the zero memory of its
``init_cache`` as the reference's launcher does), on the same float32 weights (the JAX package's
``init_lm``, cast, carried across by ``models/convert.py``) and the same
prompts (drawn as the JAX launcher draws them): every request must
generate the same tokens. The
reference's loop lives inside ``repro.launch.serve.main``; ``_jax_serve``
below is that loop, line for line, on the JAX package's own parts.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro.models.shardings import SINGLE as JSINGLE  # noqa: E402
from repro.models.shardings import ServePlan as JServePlan  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro.serve.serve_step import greedy_sample as jax_greedy  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve import serve_requests  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve import kvcache  # noqa: E402
from repro_torch.serve.serve_step import greedy_sample  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG_J = jconfigs.get_config("falcon_mamba_7b").reduced()
CFG = configs.get_config("falcon_mamba_7b").reduced()
REQUESTS, BATCH, PROMPT, MAX_NEW, CACHE_LEN = 4, 2, 8, 4, 128


def _jax_serve(params, prompts, cfg_j=CFG_J):
    """src/repro/launch/serve.py's loop on the JAX package's parts."""
    api = jax_get_model(cfg_j)
    mgr = jkv.SlotManager(batch=BATCH, cache_len=CACHE_LEN)
    for rid, prompt in enumerate(prompts):
        mgr.submit(jkv.Request(rid, prompt, MAX_NEW))
    cache = api.init_cache(cfg_j, BATCH, CACHE_LEN)
    decode = jax.jit(lambda p, t, c, pos: api.decode(p, t, c, pos, cfg_j, JSINGLE,
                                                     JServePlan()))

    def prefill_into_slot(slot, req, cache):
        for j, t in enumerate(req.prompt[:-1]):
            tok = np.zeros((BATCH, 1), np.int32)
            tok[slot, 0] = t
            _, cache = decode(params, jnp.asarray(tok), cache, jnp.asarray(j))
        return cache

    step = 0
    while mgr.live or mgr.waiting:
        for slot, req in mgr.admit():
            cache = prefill_into_slot(slot, req, cache)
        tok = jnp.asarray(mgr.step_tokens())
        pos = int(mgr.pos.max() - 1) if mgr.pos.max() else 0
        logits, cache = decode(params, tok, cache, jnp.asarray(pos))
        mgr.record(np.asarray(jax_greedy(logits))[:, 0])
        step += 1
        if step > REQUESTS * (MAX_NEW + PROMPT) + 100:
            break
    return mgr.finished


@pytest.fixture
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_loop_generates_the_references_tokens(one_thread):
    rng = jax.random.PRNGKey(0)
    api_j = jax_get_model(CFG_J)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), api_j.init(CFG_J, rng))
    prompts = [
        np.asarray(jax.random.randint(jax.random.fold_in(rng, rid), (PROMPT,), 0,
                                      CFG_J.vocab_size), np.int32)
        for rid in range(REQUESTS)
    ]
    want = [(r.rid, r.generated) for r in _jax_serve(params, prompts)]
    model = from_jax(jax.tree.map(np.asarray, params), CFG, device="cpu")
    got = serve_requests(get_model(CFG), model, CFG, prompts, batch=BATCH,
                         max_new=MAX_NEW, cache_len=CACHE_LEN)
    assert [(r.rid, r.generated) for r in got] == want
    assert len(want) == REQUESTS and all(len(g) == MAX_NEW for _, g in want)


def test_serve_loop_generates_the_references_tokens_dense(one_thread):
    """The same loop on the reduced starcoder2 (layernorm, QKV and MLP
    biases, gelu, GQA, a 64-token sliding window), float32 weights, its
    bf16 KV cache written slot by slot at the loop's shared position."""
    cfg_j = jconfigs.get_config("starcoder2_15b").reduced()
    cfg = configs.get_config("starcoder2_15b").reduced()
    rng = jax.random.PRNGKey(0)
    api_j = jax_get_model(cfg_j)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), api_j.init(cfg_j, rng))
    prompts = [
        np.asarray(jax.random.randint(jax.random.fold_in(rng, rid), (PROMPT,), 0,
                                      cfg_j.vocab_size), np.int32)
        for rid in range(REQUESTS)
    ]
    want = [(r.rid, r.generated) for r in _jax_serve(params, prompts, cfg_j)]
    model = convert.from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    got = serve_requests(get_model(cfg), model, cfg, prompts, batch=BATCH,
                         max_new=MAX_NEW, cache_len=CACHE_LEN)
    assert [(r.rid, r.generated) for r in got] == want
    assert len(want) == REQUESTS and all(len(g) == MAX_NEW for _, g in want)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "seamless_m4t_large_v2"])
def test_serve_loop_generates_the_references_tokens_hybrid_encdec(arch, one_thread):
    """The same loop on the hybrid's nested cache (conv and LRU states,
    a 64-slot window ring that the 12 positions never wrap) and on the
    encdec's self-attention cache beside its zero cross-attention memory."""
    cfg_j = jconfigs.get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    rng = jax.random.PRNGKey(0)
    api_j = jax_get_model(cfg_j)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), api_j.init(cfg_j, rng))
    prompts = [
        np.asarray(jax.random.randint(jax.random.fold_in(rng, rid), (PROMPT,), 0,
                                      cfg_j.vocab_size), np.int32)
        for rid in range(REQUESTS)
    ]
    want = [(r.rid, r.generated) for r in _jax_serve(params, prompts, cfg_j)]
    model = convert.from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    got = serve_requests(get_model(cfg), model, cfg, prompts, batch=BATCH,
                         max_new=MAX_NEW, cache_len=CACHE_LEN)
    assert [(r.rid, r.generated) for r in got] == want
    assert len(want) == REQUESTS and all(len(g) == MAX_NEW for _, g in want)


def _state(mgr):
    return (
        [None if r is None else r.rid for r in mgr.slots],
        mgr.pos.tolist(),
        [r.rid for r in mgr.waiting],
        [(r.rid, list(r.generated)) for r in mgr.finished],
        mgr.live,
    )


@pytest.mark.parametrize("seed", range(4))
def test_slot_manager_is_the_references(seed):
    """Random submit / admit / record sequences through both SlotManagers."""
    rng = np.random.default_rng(seed)
    batch, cache_len = int(rng.integers(1, 5)), int(rng.integers(4, 12))
    port, ref = kvcache.SlotManager(batch, cache_len), jkv.SlotManager(batch, cache_len)
    for rid in range(int(rng.integers(3, 10))):
        prompt = rng.integers(0, 100, int(rng.integers(1, 7))).astype(np.int32)
        max_new = int(rng.integers(1, 6))
        port.submit(kvcache.Request(rid, prompt, max_new))
        ref.submit(jkv.Request(rid, prompt, max_new))
    for _ in range(60):
        if rng.random() < 0.3:
            assert ([(s, r.rid) for s, r in port.admit()]
                    == [(s, r.rid) for s, r in ref.admit()])
        np.testing.assert_array_equal(port.step_tokens(), ref.step_tokens())
        nxt = rng.integers(0, 100, batch).astype(np.int32)
        port.record(nxt)
        ref.record(nxt)
        assert _state(port) == _state(ref)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_9b",
                                  "seamless_m4t_large_v2"])
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("batch,cache_len", [(1, 128), (4, 128), (128, 32768)])
def test_cache_bytes(reduced, batch, cache_len, arch):
    """Over the ssm's flat cache, the hybrid's nested one (a window ring
    shorter than the context at full width) and the encdec's four leaves."""
    cfg, cfg_j = configs.get_config(arch), jconfigs.get_config(arch)
    if reduced:
        cfg, cfg_j = cfg.reduced(), cfg_j.reduced()
    assert (kvcache.cache_bytes(cfg, get_model(cfg), batch, cache_len)
            == jkv.cache_bytes(cfg_j, jax_get_model(cfg_j), batch, cache_len))


@pytest.mark.parametrize("seed", range(3))
def test_greedy_sample_takes_the_first_maximum(seed):
    rng = np.random.default_rng(seed)
    logits = rng.integers(0, 4, (6, 32)).astype(np.float32)  # many ties
    got = greedy_sample(torch.from_numpy(logits))
    assert got.dtype == torch.int32 and got.shape == (6, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_greedy(jnp.asarray(logits))))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_registry(arch):
    """The reference's ids, every one ported: each resolves to the
    reference's config and family and trains through the loss of the
    reference's name and module (its family's ``lm_loss``; the
    registry's ``_moe_loss``)."""
    from repro_torch.models import encdec, mamba, rglru, transformer

    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.PORTED == configs.ARCH_IDS
    want = jconfigs.get_config(arch)
    cfg = configs.get_config(arch.replace("_", "-"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert get_model(cfg).family == jax_get_model(want).family
    loss, ref_loss = get_model(cfg).loss, jax_get_model(want).loss
    if want.family != "moe":
        family_module = {"ssm": mamba, "hybrid": rglru, "encdec": encdec}.get(want.family,
                                                                             transformer)
        assert loss is family_module.lm_loss
    assert loss.__name__ == ref_loss.__name__
    assert loss.__module__.rsplit(".", 1)[-1] == ref_loss.__module__.rsplit(".", 1)[-1]
    with pytest.raises(KeyError):
        configs.get_config("no_such_arch")


def test_launcher_serves_on_the_cpu_when_asked():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "falcon_mamba_7b",
         "--reduced", "--device", "cpu", "--requests", "3", "--batch", "2",
         "--prompt-len", "6", "--max-new", "3"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests, 9 tokens" in proc.stdout


@pytest.mark.parametrize("arch", ["qwen2_72b", "recurrentgemma_9b", "seamless_m4t_large_v2"])
def test_launcher_serves_a_dense_arch_on_the_cpu(arch):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--requests", "3", "--batch", "2",
         "--prompt-len", "6", "--max-new", "3"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests, 9 tokens" in proc.stdout
