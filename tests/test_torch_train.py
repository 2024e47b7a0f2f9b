"""The port's training path (``repro_torch.train``, ``repro_torch.data``,
``models.mamba.lm_loss``) against the JAX package's, on the reduced
falcon-mamba cut to 2 layers (d_model 128, N 8, vocab 512, scan_chunk
16), seq 32, batch 2 or 4: the twin of tests/test_train_serve.py's
training half (its elastic and pipeline cases, and the launcher, are in
tests/test_torch_train_units.py). The reference's own training cases
run on a dense model, ``qwen2_72b.reduced(num_layers=2)`` (QKV biases,
an untied head): ``tiny_trainer``'s kill -> degraded restore -> repair
-> resume, the int8-v optimizer and the step-0 checkpoint; the train
step is also held on it, on the reduced olmoe (moe: the aux loss, the
f32 router) and on the reduced pixtral (vlm: the ``patch_embed``
prefix), each cut to 2 layers.

Weights go across by ``models/convert.py``. Tolerances, set from
float32 before the runs:

- ``lm_loss`` rtol = atol = 1e-4, and each gradient leaf within 1e-3 of
  its max |ref| (only the order of f32 sums differs);
- ``_chunk_scan`` bit for bit (the same odd/even association);
- three ``make_train_step`` steps: the loss rtol = atol = 1e-4, and each
  parameter within 1e-6 of its leaf's max |ref| plus a tenth of the
  peak learning rate. AdamW's first steps move an element by
  lr * g / (|g| + eps): where a gradient element is near eps, the last
  bits of its sum (the frameworks add in other orders) move the update
  by a fraction of lr (measured: under 0.025 lr);
- the checkpoint bytes: equal.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as JPipeline  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro.models.shardings import SINGLE as JSINGLE  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.train.loop import LoopConfig as JLoopConfig  # noqa: E402
from repro.train.loop import Trainer as JTrainer  # noqa: E402
import torch_model_cases as C  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticPipeline  # noqa: E402
from repro_torch.models import convert, mamba  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.models.shardings import SINGLE  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.loop import LoopConfig, Trainer  # noqa: E402

CFG_J = jax_get_config("falcon_mamba_7b").reduced(num_layers=2)
CFG = get_config("falcon_mamba_7b").reduced(num_layers=2)
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
DENSE = "qwen2_72b"
HYBRID, ENCDEC = "recurrentgemma_9b", "seamless_m4t_large_v2"


def _cfgs(case: str):
    """(port, reference) config of a case: ``arch`` at
    ``reduced(num_layers=2)``, or ``arch/4L-block2`` at 4 layers in two
    remat blocks of two (the two-level remat)."""
    arch, _, variant = case.partition("/")
    kw = dict(num_layers=4, remat_block=2) if variant else dict(num_layers=2)
    if arch == HYBRID:  # one (rec, rec, attn) group and a one-block tail
        kw = dict(num_layers=4)
    return get_config(arch).reduced(**kw), jax_get_config(arch).reduced(**kw)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params_f32():
    """The reference's init_lm, cast to float32, as numpy leaves."""
    p = jmamba.init_lm(CFG_J, jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), p)


def _port_tree(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _leaf_pairs(ref_tree, port_tree):
    """(path, ref numpy, port numpy) over the reference's leaves."""
    out = []
    for path, ref in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        port = _port_tree(port_tree, path)
        out.append((jax.tree_util.keystr(path), np.asarray(ref), port.detach().numpy()))
    return out


def _bits(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(leaf).tobytes()


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


def test_lm_loss_and_grads_match_reference(params_f32):
    batch = JPipeline(CFG_J, 32, 2, 0).batch_at(0)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmamba.lm_loss(p, b, CFG_J, JSINGLE)))(params_f32, batch)
    model = convert.from_jax(params_f32, CFG, device="cpu", trainable=True)
    loss = mamba.lm_loss(model, batch, CFG)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-4, atol=1e-4)
    pairs = _leaf_pairs(ref_grads, convert.stacked_tree(model, grads))
    assert len(pairs) == (len(list(model.parameters())) - 2) // CFG.num_layers + 2
    for path, ref, port in pairs:
        assert port.shape == ref.shape, path
        assert np.max(np.abs(port - ref)) <= 1e-3 * np.max(np.abs(ref)), path


def test_eval_step_runs_k8_and_matches_the_train_loss(params_f32, monkeypatch):
    """Without grad the mixer takes K8 (its plain version on the CPU),
    under grad ``_chunk_scan``: the losses agree with the reference's."""
    calls = []
    real = mamba.selective_scan
    monkeypatch.setattr(mamba, "selective_scan", lambda *a, **k: calls.append(1) or real(*a, **k))
    batch = JPipeline(CFG_J, 32, 2, 0).batch_at(1)
    ref = float(jmamba.lm_loss(params_f32, batch, CFG_J, JSINGLE))
    model = convert.from_jax(params_f32, CFG, device="cpu", trainable=True)
    state = ts.TrainState(model, None, torch.zeros((), dtype=torch.int32))
    evaluated = float(ts.make_eval_step(CFG, get_model(CFG), SINGLE)(state, batch))
    k8_calls = len(calls)
    trained = mamba.lm_loss(model, batch, CFG)
    assert trained.requires_grad and len(calls) == k8_calls
    assert k8_calls == CFG.num_layers * 32 // CFG.scan_chunk
    np.testing.assert_allclose([evaluated, float(trained.detach())], [ref, ref],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c", [1, 2, 7, 13, 16])
def test_chunk_scan_matches_reference(c):
    rng = np.random.default_rng(c)
    da = rng.uniform(0.5, 1.0, (2, c, 32, 8)).astype(np.float32)
    dbu = rng.standard_normal((2, c, 32, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 32, 8)).astype(np.float32)
    ref_all, ref_last = jmamba._chunk_scan(jnp.asarray(da), jnp.asarray(dbu), jnp.asarray(h0))
    h_all, h_last = mamba._chunk_scan(*(torch.from_numpy(a) for a in (da, dbu, h0)))
    np.testing.assert_array_equal(h_all.numpy(), np.asarray(ref_all))
    np.testing.assert_array_equal(h_last.numpy(), np.asarray(ref_last))


def test_chunked_xent_keeps_no_logits(params_f32):
    """Each chunk's (B, chunk, V) logits are recomputed in backward: the
    graph holds no tensor of vocab width."""
    from repro_torch.models.transformer import chunked_xent

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 32, 128)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(params_f32["embed"])
    labels = torch.from_numpy(rng.integers(0, CFG.vocab_size, (2, 32)))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        loss = chunked_xent(x, w, labels, CFG, chunk=8)
    assert saved and all(CFG.vocab_size not in shape[1:] for shape in saved), saved
    lse = jax.jit(lambda a: jax.nn.logsumexp(a @ params_f32["embed"].T, axis=-1))
    ref = lse(x.detach().numpy())
    ll = np.take_along_axis(x.detach().numpy() @ params_f32["embed"].T,
                            labels.numpy()[..., None], -1)[..., 0]
    np.testing.assert_allclose(float(loss.detach()), float(np.mean(np.asarray(ref) - ll)),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _twin_states(params_f32, oc_kw, cfg=CFG):
    jp = jax.tree.map(jnp.asarray, params_f32)
    jstate = jts.TrainState(jp, jopt.init_opt_state(jp, jopt.OptConfig(**oc_kw)),
                            jnp.zeros((), jnp.int32))
    model = convert.from_jax(params_f32, cfg, device="cpu", trainable=True)
    opt_state = convert.tree_to(jax.tree.map(np.asarray, jstate.opt), "cpu")
    return jstate, ts.TrainState(model, opt_state, torch.zeros((), dtype=torch.int32))


def _three_steps_match(params_f32, microbatches, cfg=CFG, cfg_j=CFG_J):
    """Three train steps of both packages from the same state, on the
    same stream (each package's pipeline, equal bit for bit)."""
    jstate, state = _twin_states(params_f32, OPT, cfg)
    jstep = jax.jit(jts.make_train_step(cfg_j, jax_get_model(cfg_j), JSINGLE,
                                        jopt.OptConfig(**OPT), microbatches=microbatches))
    step = ts.make_train_step(cfg, get_model(cfg), SINGLE, opt.OptConfig(**OPT),
                              microbatches=microbatches)
    jpipeline, pipeline = JPipeline(cfg_j, 32, 4, 0), SyntheticPipeline(cfg, 32, 4, 0)
    for i in range(3):
        jstate, jm = jstep(jstate, jpipeline.batch_at(i))
        state, m = step(state, pipeline.batch_at(i))
        assert int(state.step) == int(jstate.step) == i + 1 == int(m["step"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        for path, ref, port in _leaf_pairs(jstate.params, convert.stacked_tree(state.params)):
            assert port.shape == ref.shape, path
            tol = 1e-6 * np.max(np.abs(ref)) + 0.1 * OPT["lr"]
            assert np.max(np.abs(port - ref)) <= tol, (i, path)
    assert all(p.requires_grad for p in state.params.parameters())
    assert all(p.grad is None for p in state.params.parameters())


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(params_f32, microbatches):
    _three_steps_match(params_f32, microbatches)


@pytest.mark.parametrize("case, microbatches", [
    (DENSE, 1), (DENSE, 2), ("starcoder2_15b/4L-block2", 1), ("olmoe_1b_7b", 1),
    ("granite_moe_3b_a800m", 1), ("pixtral_12b", 1)])
def test_transformer_train_step_matches_reference(case, microbatches):
    """The same three steps on the dense, moe and vlm trees: qwen2's QKV
    biases; starcoder2's biases and layernorm ``bias`` leaves under the
    two-level remat; olmoe's f32 router and aux loss; granite's tied
    head; pixtral's ``patch_embed`` prefix, carried by every batch."""
    cfg, cfg_j = _cfgs(case)
    p = jax_get_model(cfg_j).init(cfg_j, jax.random.PRNGKey(0))
    batch = SyntheticPipeline(cfg, 32, 4, 0).batch_at(0)
    assert ("patch_embed" in batch) == (cfg.family == "vlm")
    assert cfg.remat_block == 0 or cfg.num_layers > cfg.remat_block
    _three_steps_match(jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), p), microbatches,
                       cfg, cfg_j)


@pytest.mark.parametrize("arch", [HYBRID, ENCDEC])
def test_hybrid_encdec_train_step_matches_reference(arch, monkeypatch):
    """Three train steps of the port on the hybrid tree (the stacked
    group, the unstacked ``tail`` list) and the encdec tree (the batch's
    ``src_embed`` frames through the encoder), each held to the
    reference: the loss its ``lm_loss`` on the same state and batch
    (rtol = atol = 1e-4; the encdec one op by op with its encoder
    unrolled, tests/torch_model_cases.py), and the update to the
    reference's AdamW applied to the gradients the port's step handed
    its own (every parameter, m and v leaf within 1e-6 of its max |ref|,
    the grad norm and lr within 1e-6). The gradients themselves are
    held in tests/test_torch_model_grads.py (hybrid) and
    tests/test_torch_loss_paths.py (encdec). The dense cases' bound on
    the update from the reference's own gradients (a tenth of lr) does
    not hold here: these trees have gradient elements within 1e-7 of
    zero whose sign the order of float32 sums decides (measured: the
    hybrid's embedding, 4e-9 against -1e-7), and AdamW's first step
    moves such an element by up to lr either way."""
    cfg, cfg_j = _cfgs(arch)
    params_f32 = jax.tree.map(lambda a: np.asarray(a, np.float32),
                              jax_get_model(cfg_j).init(cfg_j, jax.random.PRNGKey(0)))
    jstate, state = _twin_states(params_f32, OPT, cfg)
    oc_j = jopt.OptConfig(**OPT)
    handed = {}
    real = opt.adamw_update_

    def spy(grads, st, params, c):
        handed["grads"] = convert.tree_to(grads, "cpu")
        return real(grads, st, params, c)

    monkeypatch.setattr(opt, "adamw_update_", spy)
    step = ts.make_train_step(cfg, get_model(cfg), SINGLE, opt.OptConfig(**OPT))
    jupdate = jax.jit(lambda g, st, p: jopt.adamw_update(g, st, p, oc_j))
    jpipeline, pipeline = JPipeline(cfg_j, 32, 4, 0), SyntheticPipeline(cfg, 32, 4, 0)
    with C.reference(cfg_j, "float32") as run:
        jloss_fn = run(lambda p, b: jax_get_model(cfg_j).loss(p, b, cfg_j, JSINGLE))
        for i in range(3):
            jbatch = jpipeline.batch_at(i)
            jloss = jloss_fn(jstate.params, jbatch)
            state, m = step(state, pipeline.batch_at(i))
            np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-4, atol=1e-4)
            grads = jax.tree.map(np.asarray, handed["grads"])
            jp, jo, jm = jupdate(grads, jstate.opt, jstate.params)
            jstate = jts.TrainState(jp, jo, jstate.step + 1)
            assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
            assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
            ours = {"params": convert.stacked_tree(state.params), "m": state.opt["m"],
                    "v": state.opt["v"]}
            for path, ref, port in _leaf_pairs({"params": jp, "m": jo["m"], "v": jo["v"]},
                                                ours):
                assert port.shape == ref.shape, path
                assert np.max(np.abs(port - ref)) <= 1e-6 * np.max(np.abs(ref)), (i, path)
    assert int(state.step) == 3
    assert isinstance(state.opt["m"]["tail"] if arch == HYBRID else state.opt["m"]["enc"],
                      list if arch == HYBRID else dict)


def test_microbatches_accumulate_in_f32(monkeypatch):
    """With microbatches the gradients are summed in f32 and divided by
    the count: a bf16 model's averaged gradient is the f32 mean of the
    microbatch gradients, not a bf16 running sum."""
    model = get_model(CFG).init(CFG, 0, device="cpu")
    model.requires_grad_(True)
    batch = SyntheticPipeline(CFG, 32, 4, 0).batch_at(0)
    seen = {}
    real = opt.adamw_update_

    def spy(grads, state, params, c):
        seen["grads"] = grads
        return real(grads, state, params, c)

    state = ts.TrainState(model, opt.init_opt_state(convert.stacked_tree(model),
                                                    opt.OptConfig()),
                          torch.zeros((), dtype=torch.int32))
    halves = [{k: v[i * 2 : (i + 1) * 2] for k, v in batch.items()} for i in range(2)]
    parts = [torch.autograd.grad(mamba.lm_loss(model, h, CFG), list(model.parameters()))
             for h in halves]
    want = convert.stacked_tree(model, [(a.float() + b.float()) / 2 for a, b in zip(*parts)])
    monkeypatch.setattr(opt, "adamw_update_", spy)
    ts.make_train_step(CFG, get_model(CFG), SINGLE, opt.OptConfig(), microbatches=2)(state, batch)
    got = opt.tree_leaves(seen["grads"])
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, opt.tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the loop, the checkpoint and the launcher
# ---------------------------------------------------------------------------


def _tiny_trainer(cfg) -> Trainer:
    lc = LoopConfig(steps=6, ckpt_every=3, log_every=100, seq_len=32,
                    global_batch=2, num_nodes=20)
    return Trainer(cfg, lc, opt.OptConfig(**OPT), device="cpu")


@pytest.fixture(scope="module")
def tiny_trainer():
    return _tiny_trainer(CFG)


@pytest.fixture(scope="module")
def dense_tiny_trainer():
    """The reference's own ``tiny_trainer``: qwen2 cut to 2 layers."""
    return _tiny_trainer(_cfgs(DENSE)[0])


def _state_leaves(state: ts.TrainState) -> list:
    from repro_torch.checkpoint import partition

    host = ts.TrainState(convert.to_reference_tree(state.params), state.opt, state.step)
    return partition.flatten(host)[0]


def _kill_restore_resume(tr: Trainer):
    state = tr.run()
    assert int(state.step) == 6
    losses = [m["loss"] for m in tr.metrics_log]
    assert len(losses) == 6 and all(np.isfinite(loss) for loss in losses)
    assert sorted(tr.ckpt.manifests) == [3, 6]

    # kill two storage nodes -> degraded restore must still be bit-exact
    tr.store.fail_nodes([0, 1])
    restored = tr.restore_latest()
    assert restored is not None and restored.params is not state.params
    saved, back = _state_leaves(state), _state_leaves(restored)
    assert len(saved) == len(back)
    for a, b in zip(saved, back):
        assert a.dtype == b.dtype and a.shape == b.shape and _bits(a) == _bits(b)
    assert tr.last_restore_report.blocks_fetched > 0
    assert all(p.requires_grad for p in restored.params.parameters())

    # background repair regenerates the dead nodes' blocks
    tr.store.heal_node(0)
    tr.store.heal_node(1)
    rep = tr.ckpt.repair(6)
    assert rep.recovered

    # resume training from the restored state: the same losses as going on
    # from the state in memory
    state2 = tr.run(state=restored, until=8)
    assert int(state2.step) == 8
    resumed = [m["loss"] for m in tr.metrics_log[6:]]
    tr.run(state=state, until=8)
    assert resumed == [m["loss"] for m in tr.metrics_log[8:]]


def test_train_ckpt_kill_restore_resume(tiny_trainer):
    _kill_restore_resume(tiny_trainer)


def test_dense_train_ckpt_kill_restore_resume(dense_tiny_trainer):
    _kill_restore_resume(dense_tiny_trainer)


def _quantized_v_converges(cfg) -> ts.TrainState:
    lc = LoopConfig(steps=5, ckpt_every=100, log_every=100, seq_len=32, global_batch=2)
    tr = Trainer(cfg, lc, opt.OptConfig(lr=1e-3, quantize_v=True, warmup_steps=1,
                                        decay_steps=10), device="cpu")
    state = tr.run()
    assert np.isfinite(tr.metrics_log[-1]["loss"])
    leaves = [x for v in opt.tree_leaves(state.opt["v"]) for x in v]
    assert any(leaf.dtype == torch.int8 for leaf in leaves)
    return state


def test_quantized_v_optimizer_converges():
    _quantized_v_converges(CFG)


def test_dense_quantized_v_optimizer_converges():
    """On qwen2, whose int8 v blocks fall per stacked leaf as the
    reference's do: the same (q, scale) shapes for every leaf."""
    cfg, cfg_j = _cfgs(DENSE)
    state = _quantized_v_converges(cfg)
    jp = jax_get_model(cfg_j).init(cfg_j, jax.random.PRNGKey(0))
    jv = jopt.init_opt_state(jp, jopt.OptConfig(quantize_v=True))["v"]
    want = [(tuple(q.shape), tuple(sc.shape)) for q, sc in
            jax.tree.leaves(jv, is_leaf=lambda x: isinstance(x, tuple))]
    got = [(tuple(q.shape), tuple(sc.shape)) for q, sc in opt.tree_leaves(state.opt["v"])]
    assert got == want


def _save_matches(cfg, cfg_j):
    jlc = JLoopConfig(steps=1, seq_len=32, global_batch=2, num_nodes=20)
    jtr = JTrainer(cfg_j, jlc, jopt.OptConfig(**OPT))
    jstate = jtr.init_state()
    jman = jtr.save(jstate)
    tr = Trainer(cfg, LoopConfig(steps=1, seq_len=32, global_batch=2, num_nodes=20),
                 opt.OptConfig(**OPT), device="cpu")
    host = jax.tree.map(np.asarray, jstate)
    state = ts.TrainState(convert.from_jax(host.params, cfg, device="cpu", trainable=True),
                          convert.tree_to(host.opt, "cpu"), convert.to_tensor(host.step, "cpu"))
    man = tr.save(state)
    assert man.total_bytes == jman.total_bytes and man.group_ids == jman.group_ids
    assert [vars(s) for s in man.leaf_specs] == [vars(s) for s in jman.leaf_specs]
    assert {s.dtype for s in man.leaf_specs} >= {"bfloat16", "float32", "int32"}
    assert tr.store.placement == jtr.store.placement
    assert tr.store.checksums == jtr.store.checksums
    assert all(np.array_equal(blk, jtr.store.blocks[key]) for key, blk in tr.store.blocks.items())


def test_save_matches_reference_trainer():
    """A step-0 state of the reference's Trainer, converted, saved by the
    port's Trainer: the same stream, leaf specs, group matrices,
    placement and checksums as the reference's Trainer.save."""
    _save_matches(CFG, CFG_J)


@pytest.mark.parametrize("arch", [DENSE, "olmoe_1b_7b", "granite_moe_3b_a800m"])
def test_transformer_save_matches_reference_trainer(arch):
    """The same on the dense tree (biases) and the moe trees (the f32
    router; granite's tied head)."""
    _save_matches(*_cfgs(arch))


@pytest.mark.parametrize("arch", [HYBRID, ENCDEC])
def test_hybrid_encdec_save_matches_reference_trainer(arch):
    """The same on the hybrid tree (the stacked group, the ``tail`` list
    of unstacked blocks, bf16 RG-LRU gates beside f32 ``lam``) and the
    encdec tree (``enc``, ``dec``, the untied head)."""
    _save_matches(*_cfgs(arch))


def test_hybrid_tail_decay_rule():
    """AdamW decays a leaf of rank >= 2 only, as the reference's does: a
    norm scale stacked in ``groups`` (G, d) decays, the same scale in the
    unstacked ``tail`` (d,) does not. With zero gradients, one update
    moves exactly the decayed leaves, and both packages move them to the
    same values."""
    cfg, cfg_j = _cfgs(HYBRID)
    c = dict(OPT, weight_decay=0.5, warmup_steps=0)
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      jax_get_model(cfg_j).init(cfg_j, jax.random.PRNGKey(0)))
    jzero = jax.tree.map(np.zeros_like, jp)
    jnew, _, _ = jopt.adamw_update(jzero, jopt.init_opt_state(jp, jopt.OptConfig(**c)), jp,
                                   jopt.OptConfig(**c))
    params = convert.tree_to(jp, "cpu")
    zero = opt.tree_map(torch.zeros_like, params)
    new, _, _ = opt.adamw_update(zero, opt.init_opt_state(params, opt.OptConfig(**c)), params,
                                 opt.OptConfig(**c))
    before = {path: ref for path, ref, _ in _leaf_pairs(jp, params)}
    ranks = {}
    for path, ref, port in _leaf_pairs(jnew, new):
        np.testing.assert_array_equal(port, ref, err_msg=path)
        moved = not np.array_equal(ref, before[path])
        assert moved == (ref.ndim >= 2 and bool(before[path].any())), path
        ranks[path] = ref.ndim
    assert ranks["['groups']['b0']['ln1']['scale']"] == 2
    assert ranks["['tail'][0]['ln1']['scale']"] == 1


def test_trainer_mesh_waits_for_its_slice():
    """Its slice has come (tests/test_torch_mesh_train.py trains on a 2 x 2
    mesh, tests/test_torch_mesh_quantize.py with the int8 second moment);
    what a mesh still refuses: a mesh of another device type than the
    trainer's."""
    import types

    with pytest.raises(ValueError, match="cuda mesh"):
        Trainer(CFG, LoopConfig(), mesh=types.SimpleNamespace(device_type="cuda"),
                device="cpu")
