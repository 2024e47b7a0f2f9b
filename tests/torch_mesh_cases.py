"""Shared by tests/test_torch_mesh_train.py and
tests/test_torch_mesh_families.py: 4 gloo rank processes on a 2 x 2 mesh
(CPU), spawned once per test file, which run only the port (and numpy)
and write their measurements for the tests to hold.

``run_ranks`` converts the JAX package's ``init_lm`` weights of each
asked id (f32), runs the reference's prefill and decodes of the serve
ids (``_jax_serve``) and, when asked, its unsharded decode on the
``DECODE_CASES``; the ranks then run, per id, one f32 train step on the
mesh against the port's single-device step, the prefill and decodes on
the mesh against the port's single-device calls and the reference's,
the CORE save/restore of a ``Trainer(mesh=...)`` and the
sequence-sharded decode."""

from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models.registry import get_model as jax_get_model
from repro.models.shardings import SINGLE as JSINGLE
from repro.models.shardings import ServePlan as JServePlan

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (sliding_window, batch, plan, pos): T = 128 slots; pos 150 has wrapped the ring
DECODE_CASES = [(w, b, plan, pos) for w in (None, 64) for b, plan in ((1, "both"), (2, "model"))
                for pos in (40, 150)]
CACHE_LEN = 128
# the single-device serving twins' float32 tolerance (rtol = atol), and the
# share of a bf16 cache leaf that may be one-ulp neighbours of the
# reference's values (torch_model_cases.F32_TOL, FLIP_SHARE)
F32_TOL, FLIP_SHARE = 1e-4, 1e-3


# ids run with other than reduced()'s sizes: granite with 3 experts, which
# tp = 2 does not divide, so each expert's hidden dim is on tp instead
VARIANTS = {"granite_moe_3b_a800m@ff": ("granite_moe_3b_a800m", {"num_experts": 3})}


def layers_of(arch: str) -> int:
    """2 layers; the hybrid's 3 are one (rec, rec, attn) group."""
    return 3 if jax_get_config(arch).family == "hybrid" else 2


SCRIPT = r"""
import os, pickle, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def train_case(arch, layers, tree, mesh, over=None, quantize=False):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import convert
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import SINGLE
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.loop import LoopConfig, Trainer

    cfg = get_config(arch).reduced(num_layers=layers, **(over or {}))
    api = get_model(cfg)
    oc = opt.OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10, quantize_v=quantize)
    batch = SyntheticPipeline(cfg, 32, 4, 0).device_batch(0, "cpu")

    def state():
        model = convert.from_jax(tree, cfg, device="cpu", dtype=torch.float32, trainable=True)
        return ts.TrainState(model, opt.init_opt_state(convert.stacked_tree(model), oc),
                             torch.zeros((), dtype=torch.int32))

    ref = state()
    ref_loss = api.loss(ref.params, batch, cfg, SINGLE)
    ref_grads = torch.autograd.grad(ref_loss, list(ref.params.parameters()))
    ref_new, ref_m = ts.make_train_step(cfg, api, SINGLE, oc)(ref, batch)
    ref_params = [p.detach() for p in ref_new.params.parameters()]

    tr = Trainer(cfg, LoopConfig(seq_len=32, global_batch=4), oc, mesh=mesh, device="cpu")
    sh = tr.place_state(state())
    db = tr.pipeline.device_batch(0, "cpu", mesh, tr.ax)
    with mesh_context(mesh):
        loss = api.loss(sh.params, db, cfg, tr.ax)
        grads = torch.autograd.grad(loss, list(sh.params.parameters()))
        new, m = tr.step_fn(sh, db)
    # the port's AdamW on this run's own (gathered) gradients, from the
    # same initial state: AdamW's first step divides g by |g| + eps, so a
    # gradient near eps turns a 1e-6 relative difference into up to lr
    init = state()
    own, _, _ = opt.adamw_update(
        convert.stacked_tree(init.params, [g.full_tensor() for g in grads]), init.opt,
        convert.stacked_tree(init.params), oc)
    got = convert.stacked_tree(new.params)
    from repro_torch.models.stack import tree_leaves
    new_params = [p.full_tensor() for p in new.params.parameters()]
    return {
        "own_adamw_abs": max(float((a.full_tensor() - b).abs().max())
                             for a, b in zip(tree_leaves(got), tree_leaves(own))),
        "param_abs_large_g": max(float(((p - r).abs() * (g.abs() >= 1e-6)).max())
                                 for p, r, g in zip(new_params, ref_params, ref_grads)),
        "loss": float(loss.full_tensor()), "ref_loss": float(ref_loss),
        "step_loss": float(m["loss"]), "ref_step_loss": float(ref_m["loss"]),
        "grad_rel": max(rel(g.full_tensor(), r) for g, r in zip(grads, ref_grads)),
        "grad_rel_by_leaf": {name: rel(g.full_tensor(), r) for (name, _), g, r in
                             zip(ref.params.named_parameters(), grads, ref_grads)},
        "param_abs": max(float((p - r).abs().max()) for p, r in zip(new_params, ref_params)),
        "lr": oc.lr,
        "grad_norm_rel": abs(float(m["grad_norm"]) / float(ref_m["grad_norm"]) - 1),
        "sharded": sum(any(type(pl).__name__ == "Shard" for pl in p.placements)
                       for p in new.params.parameters()),
        "leaves": len(ref_params),
    }


def bf16_ulps(got, want):
    # max |got - want| over bf16 want beyond the f32 tolerance (1e-5 of
    # max |want|: the value before its rounding), in units of each
    # element's bf16 spacing (8 bits of precision: 2^(e - 8) for |want|
    # in [2^(e-1), 2^e)); at most 1 when each element is the rounding of
    # a value within the f32 tolerance
    w = want.float()
    _, e = torch.frexp(w)
    over = ((got.float() - w).abs() - 1e-5 * w.abs().max()).clamp(min=0)
    return float((over / torch.ldexp(torch.ones_like(w), e - 8)).max())


def vs_jax(got, want, tol):
    # the single-device twins' check (torch_model_cases.assert_f32_close):
    # (elements beyond rtol = atol = tol, those of a bf16 leaf that are
    # one-ulp neighbours of the reference's value, as a share of the leaf)
    g, w = got.float(), torch.from_numpy(want)
    bad = (g - w).abs() > tol + tol * w.abs()
    flips = 0
    if got.dtype == torch.bfloat16:
        adj = (got.view(torch.int16).int() - w.to(torch.bfloat16).view(torch.int16).int()).abs() == 1
        flips = int((bad & adj).sum())
        bad &= ~adj
    return int(bad.sum()), flips / g.numel()


def serve_case(arch, layers, tree, mesh, jax_run, tol):
    # the prefill and two greedy decodes with DTensor parameters, batch,
    # tokens and caches, against the same calls on one device and against
    # the JAX package's (``jax_run``: its prefill, the greedy tokens of
    # its logits, and its decodes from its prefill cache cast to f32, as
    # the single-device twins run them); each call on the mesh takes the
    # unsharded run's inputs (its cache laid out by cache_specs), and the
    # port's decodes start from the reference's prefill cache in f32 and
    # take its tokens. The dense and window caches are bf16, so an f32
    # sum in another order may round a written element to its neighbour:
    # the prefill's cache is held to one bf16 spacing of the unsharded run
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticPipeline, batch_specs
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import convert
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import (SINGLE, P, ServePlan, axes_for_mesh, distribute,
                                              make_serve_plan)
    from repro_torch.models.stack import tree_map, tree_paths

    cfg = get_config(arch).reduced(num_layers=layers)
    api = get_model(cfg)
    ax = axes_for_mesh(mesh)
    b, s, cache_len = 4, 16, 32
    batch = SyntheticPipeline(cfg, s, b, 0).device_batch(0, "cpu")
    batch.pop("labels")
    ref = convert.from_jax(tree, cfg, device="cpu", dtype=torch.float32)
    model = convert.from_jax(tree, cfg, device="cpu", dtype=torch.float32)
    convert.distribute_params(model, api.specs(cfg, ax), mesh)
    plan = make_serve_plan(cfg, ax, b, cache_len)
    specs, cspecs = batch_specs(cfg, ax), api.cache_specs(cfg, ax, b, plan)
    out = {"logits_rel": [], "cache_f32_rel": 0.0, "cache_bf16_ulps": 0.0, "jax_bad": 0,
           "jax_flip_share": 0.0, "jax_logits_rel": []}

    def hold(got_logits, got_cache, want_logits, want_cache, jax_logits, jax_cache):
        got_logits = got_logits.full_tensor()
        out["logits_rel"].append(rel(got_logits, want_logits))
        out["jax_logits_rel"].append(rel(got_logits, torch.from_numpy(jax_logits)))
        got_leaves, jax_leaves = tree_paths(got_cache), tree_paths(jax_cache)
        pairs = [(got_logits, jax_logits)]
        for path, w in tree_paths(want_cache).items():
            g = got_leaves[path].full_tensor()
            pairs.append((g, jax_leaves[path]))
            if w.dtype == torch.bfloat16:
                out["cache_bf16_ulps"] = max(out["cache_bf16_ulps"], bf16_ulps(g, w))
            else:
                out["cache_f32_rel"] = max(out["cache_f32_rel"], rel(g, w))
        for g, j in pairs:
            bad, share = vs_jax(g, j, tol)
            out["jax_bad"] += bad
            out["jax_flip_share"] = max(out["jax_flip_share"], share)

    logits, cache = api.prefill(ref, batch, cfg, SINGLE, cache_len)
    with mesh_context(mesh):
        got = api.prefill(model, {k: distribute(v, specs[k], mesh) for k, v in batch.items()},
                          cfg, ax, cache_len)
    hold(*got, logits, cache, *jax_run["prefill"])
    cache = tree_map(lambda a: torch.from_numpy(a), jax_run["prefill"][1])
    for i, (tok, jax_step) in enumerate(zip(jax_run["tokens"], jax_run["decode"])):
        tok = torch.from_numpy(tok)
        with mesh_context(mesh):
            got = api.decode(model, distribute(tok, P(plan.batch_axes, None), mesh),
                             tree_map(lambda sp, x: distribute(x, sp, mesh), cspecs, cache),
                             s + i, cfg, ax, plan)
        logits, cache = api.decode(ref, tok, cache, s + i, cfg, SINGLE, ServePlan())
        hold(*got, logits, cache, *jax_step)
    out["finite"] = bool(torch.isfinite(logits).all())
    out["plan"] = [plan.batch_axes, plan.seq_axes, plan.kv_axes]
    return out


def host_copy(tree):
    # every leaf's global value on every rank (a collective for a sharded
    # leaf), copied: a replicated leaf's local tensor is its storage
    from repro_torch.models.stack import tree_map
    from repro_torch.train.loop import _gathered

    def copy(x):
        return tuple(map(copy, x)) if isinstance(x, tuple) else x.clone()

    return tree_map(lambda x: copy(_gathered(x)), tree)


def leaves_of(tree):
    # tree_leaves with the int8 v's (q, scale) split in two
    from repro_torch.models.stack import tree_leaves

    return [e for x in tree_leaves(tree) for e in (x if isinstance(x, tuple) else (x,))]


def ckpt_case(mesh, rank, quantize=False):
    # with ``quantize`` the int8 v's leaves replicate: the save on rank 0
    # is also held byte for byte against a single-device Trainer's save of
    # the same (gathered) state
    from repro_torch.configs import get_config
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.loop import LoopConfig, Trainer, _gathered
    from repro_torch.models import convert

    cfg = get_config("qwen2_72b").reduced(num_layers=2)
    oc = opt.OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10, quantize_v=quantize)
    lc = LoopConfig(steps=2, ckpt_every=2, log_every=100, seq_len=32, global_batch=4)
    tr = Trainer(cfg, lc, oc, mesh=mesh, device="cpu")
    state = tr.run()

    def flat(st):
        return (leaves_of(host_copy(convert.stacked_tree(st.params)))
                + leaves_of(host_copy(st.opt)) + [_gathered(st.step)])

    before = flat(state)
    out = {"int8_leaves": sum(x.dtype == torch.int8 for x in before)}
    params, opt_state = host_copy(convert.stacked_tree(state.params)), host_copy(state.opt)
    if rank == 0:
        single = Trainer(cfg, lc, oc, device="cpu")
        man = single.save(ts.TrainState(
            convert.from_jax(params, cfg, device="cpu", trainable=True), opt_state,
            _gathered(state.step)))
        mine = tr.ckpt.manifests[2]
        keys = [k for k in tr.store.blocks if k[0] in mine.group_ids]
        out["save_equal"] = (man.group_ids == mine.group_ids
                             and man.total_bytes == mine.total_bytes
                             and len(keys) == len(single.store.blocks)
                             and all(np.array_equal(tr.store.blocks[k], single.store.blocks[k])
                                     for k in keys))
        tr.store.fail_nodes([0, 1])
    restored = tr.restore_latest()
    after = flat(restored)
    equal = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(before, after))
    resumed = tr.run(state=restored, until=3)
    return out | {"equal": equal and len(before) == len(after), "leaves": len(before),
                  "restored_step": int(_gathered(restored.step)),
                  "resumed_step": int(_gathered(resumed.step)),
                  "losses": [r["loss"] for r in tr.metrics_log]}


def quant_case(arch, layers, tree, mesh):
    # two steps of the donated ``adamw_update_`` with the int8 v on the
    # mesh against the pure ``adamw_update`` on the gathered gradients,
    # state and parameters: every leaf's bits (p, m, q, scale), whether
    # the replicated q and scales are the same bytes on every rank, and
    # the second step's inputs and outputs as numpy for the JAX package's
    # update. The clip norm is out of reach, so the clip scale is exactly
    # 1: the global norm is the one value a sharded sum reduces in another
    # order (hold_train_step holds it to 1e-5)
    import hashlib

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import convert
    from repro_torch.models.registry import get_model
    from repro_torch.models.stack import tree_map
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.loop import LoopConfig, Trainer

    cfg = get_config(arch).reduced(num_layers=layers)
    api = get_model(cfg)
    oc = opt.OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10, quantize_v=True, clip_norm=1e6)
    tr = Trainer(cfg, LoopConfig(seq_len=32, global_batch=4), oc, mesh=mesh, device="cpu")
    model = convert.from_jax(tree, cfg, device="cpu", dtype=torch.float32, trainable=True)
    sh = tr.place_state(ts.TrainState(model, opt.init_opt_state(convert.stacked_tree(model), oc),
                                      torch.zeros((), dtype=torch.int32)))
    numpy = lambda t: tree_map(  # noqa: E731
        lambda x: tuple(e.numpy() for e in x) if isinstance(x, tuple) else x.numpy(), t)
    out = {"bits": []}
    for step in range(2):
        batch = tr.pipeline.device_batch(step, "cpu", mesh, tr.ax)
        with mesh_context(mesh):
            loss = api.loss(sh.params, batch, cfg, tr.ax)
            grads = torch.autograd.grad(loss, list(sh.params.parameters()))
        g_host = convert.stacked_tree(sh.params, [g.full_tensor() for g in grads])
        p_host, s_host = host_copy(convert.stacked_tree(sh.params)), host_copy(sh.opt)
        stacked = convert.stacked_tree(sh.params)
        new_opt, _ = opt.adamw_update_(convert.stacked_tree(sh.params, grads), sh.opt, stacked,
                                       oc)
        convert.load_stacked(sh.params, stacked)
        want_p, want_s, _ = opt.adamw_update(g_host, s_host, p_host, oc)
        got_p, got_s = host_copy(stacked), host_copy(new_opt)
        same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b, strict=True))  # noqa: E731
        v_got, v_want = opt.tree_leaves(got_s["v"]), opt.tree_leaves(want_s["v"])
        out["bits"].append({
            "p": same(opt.tree_leaves(got_p), opt.tree_leaves(want_p)),
            "m": same(opt.tree_leaves(got_s["m"]), opt.tree_leaves(want_s["m"])),
            "q": same([q for q, _ in v_got], [q for q, _ in v_want]),
            "scale": same([s for _, s in v_got], [s for _, s in v_want]),
        })
        digest = hashlib.sha256()
        for q, s in opt.tree_leaves(new_opt["v"]):
            for t in (q.to_local(), s.to_local()):
                digest.update(t.contiguous().view(torch.uint8).numpy().tobytes())
        digests = [None] * dist.get_world_size()
        dist.all_gather_object(digests, digest.hexdigest())
        out["bits"][-1]["ranks_same_v"] = len(set(digests)) == 1
        if step == 1:
            out["jax_inputs"] = {"grads": numpy(g_host), "state": numpy(s_host),
                                 "params": numpy(p_host), "lr": oc.lr, "clip_norm": oc.clip_norm}
            out["got"] = {"params": numpy(got_p), "state": numpy(got_s)}
        sh = ts.TrainState(sh.params, new_opt, sh.step + 1)
    out["v_placements"] = sorted({str(t.placements) for x in opt.tree_leaves(sh.opt["v"])
                                  for t in x})
    return out


def decode_case(case, mesh):
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import shardings as S

    cfg = get_config("qwen2_72b").reduced(sliding_window=case["window"])
    attn = L.init_attn(None, cfg, torch.float32, "cpu")
    for name, arr in case["params"].items():
        mod, _, leaf = name.rpartition(".")
        getattr(attn.get_submodule(mod), leaf).data.copy_(torch.from_numpy(arr))
    plan = (S.ServePlan(seq_axes=("data", "model")) if case["plan"] == "both"
            else S.ServePlan(batch_axes=("data",), seq_axes=("model",)))
    spec = S.P(plan.batch_axes, plan.seq_axes, None, None)
    ck, cv = (S.distribute(torch.from_numpy(case[k]), spec, mesh) for k in ("ck", "cv"))
    o, nk, nv = L.attention_decode_general(torch.from_numpy(case["x1"]), ck, cv, attn, cfg,
                                           S.SINGLE, case["pos"], plan)
    got = {"o": o, "k": nk.full_tensor(), "v": nv.full_tensor()}
    return {k: float((got[k] - torch.from_numpy(case["want_" + k])).abs().max())
            for k in got} | {"scale": float(np.abs(case["want_o"]).max()),
                             "local_slots": int(nk.to_local().shape[1])}


def run(rank, world, rdv, inputs, out):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_ranks, make_mesh

    init_ranks(rank, world, rdv, "cpu", timeout_s=120)
    try:
        with open(inputs, "rb") as f:
            data = pickle.load(f)
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        quantize = data["quantize"]
        res = {"train": {k: train_case(a, n, tree, mesh, over, quantize)
                         for k, (a, n, over, tree) in data["trees"].items()
                         if k in data["train"]},
               "quant": {k: quant_case(a, n, tree, mesh)
                         for k, (a, n, over, tree) in data["trees"].items()
                         if quantize and k in data["train"]},
               "serve": {k: serve_case(a, n, tree, mesh, data["jax_serve"][k], data["f32_tol"])
                         for k, (a, n, over, tree) in data["trees"].items()
                         if k in data["serve"]},
               "ckpt": ckpt_case(mesh, rank, quantize) if data["ckpt"] else None,
               "decode": [decode_case(c, mesh) for c in data["decode"]]}
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(run, args=(4, "file://" + os.path.join(tmp, "rdv"), sys.argv[1], sys.argv[2]),
                 nprocs=4)
"""


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _decode_inputs():
    out = []
    for i, (window, b, plan, pos) in enumerate(DECODE_CASES):
        cfg = jax_get_config("qwen2_72b").reduced(sliding_window=window)
        params = JL.init_attn(jax.random.PRNGKey(7 + i), cfg, jnp.float32)
        params = {f"{k}.{leaf}": np.asarray(v, np.float32)
                  for k, d in params.items() for leaf, v in d.items()}
        rng = np.random.default_rng(i)
        x1 = rng.standard_normal((b, 1, cfg.d_model), np.float32)
        shape = (b, CACHE_LEN, cfg.num_kv_heads, cfg.head_dim)
        ck = rng.standard_normal(shape, np.float32)
        cv = rng.standard_normal(shape, np.float32)
        jp = {k: {leaf: jnp.asarray(v) for leaf, v in
                  ((n.split(".")[1], a) for n, a in params.items() if n.startswith(k + "."))}
              for k in ("wq", "wk", "wv", "wo")}
        o, nk, nv = JL.attention_decode_general(jnp.asarray(x1), jnp.asarray(ck), jnp.asarray(cv),
                                                jp, cfg, JSINGLE, pos, JServePlan())
        out.append({"window": window, "plan": plan, "pos": pos, "params": params, "x1": x1,
                    "ck": ck, "cv": cv, "want_o": np.asarray(o), "want_k": np.asarray(nk),
                    "want_v": np.asarray(nv)})
    return out


def _jax_serve(arch: str, cfg_j, tree) -> dict:
    """The JAX package's prefill of ``serve_case``'s batch (the port's
    ``SyntheticPipeline``, 4 x 16 tokens, cache 32) and two greedy decodes
    from its prefill cache cast to f32, as tests/test_torch_models.py runs
    them (``torch_model_cases.reference``: the encdec op by op); every
    array as f32 numpy, the tokens int32."""
    import torch_model_cases as C

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticPipeline

    b, s, cache_len = 4, 16, 32
    batch = SyntheticPipeline(get_config(arch).reduced(num_layers=cfg_j.num_layers), s, b,
                              0).batch_at(0)
    batch.pop("labels")
    jbatch = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) if hasattr(v, "float")
              else jnp.asarray(v) for k, v in batch.items()}
    api_j = jax_get_model(cfg_j)
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    with C.reference(cfg_j, "float32") as run:
        jprefill = run(lambda p, b: api_j.prefill(p, b, cfg_j, JSINGLE, cache_len))
        jdecode = run(lambda p, t, c, pos: api_j.decode(p, t, c, pos, cfg_j, JSINGLE,
                                                         JServePlan()))
        params = jax.tree.map(jnp.asarray, tree)
        logits, cache = jprefill(params, jbatch)
        cache = jax.tree.map(lambda a: a.astype(jnp.float32), cache)
        out = {"prefill": (f32(logits), f32(cache)), "tokens": [], "decode": []}
        for i in range(2):
            tok = np.array(jnp.argmax(logits, axis=-1), np.int32)[:, None]
            logits, cache = jdecode(params, jnp.asarray(tok), cache, jnp.asarray(s + i))
            out["tokens"].append(tok)
            out["decode"].append((f32(logits), f32(cache)))
    return out


def hold_train_step(r: dict) -> None:
    """The tolerances of the sharded train step: the loss within 1e-5
    relative, every gradient leaf within 1e-4 of its max |ref|, the new
    parameters within 1e-5 of AdamW on the sharded run's own gradients
    and of the single-device step wherever |g| >= 1e-6 (AdamW's first
    step is g / (|g| + 1e-8): near eps it turns the gradients' 1e-6
    relative difference into up to lr), and the state really sharded."""
    assert abs(r["loss"] / r["ref_loss"] - 1) < 1e-5, r
    assert abs(r["step_loss"] / r["ref_step_loss"] - 1) < 1e-5, r
    assert r["grad_rel"] < 1e-4, r
    assert r["grad_norm_rel"] < 1e-5, r
    assert r["own_adamw_abs"] < 1e-5, r
    assert r["param_abs_large_g"] < 1e-5, r
    assert r["param_abs"] < r["lr"], r
    assert r["sharded"] > r["leaves"] // 2, r


def run_ranks(tmp: pathlib.Path, archs=(), ckpt: bool = False, decode: bool = False,
              serve=(), quantize: bool = False) -> dict:
    """Spawn the 4 ranks on ``archs``' train steps and ``serve``'s
    prefill and decodes (and the checkpoint and decode cases when
    asked); returns their measurements. With ``quantize`` the train steps
    and the checkpoint run with the int8 second moment, and each of
    ``archs`` also runs ``quant_case``."""
    trees = {}
    for key in (*archs, *serve):
        arch, over = VARIANTS.get(key, (key, {}))
        cfg = jax_get_config(arch).reduced(num_layers=layers_of(arch), **over)
        trees[key] = (arch, layers_of(arch), over,
                      _np(jax_get_model(cfg).init(cfg, jax.random.PRNGKey(0))))
    jax_serve = {}
    for key in serve:
        arch, _, _, tree = trees[key]
        jax_serve[key] = _jax_serve(arch, jax_get_config(arch).reduced(
            num_layers=layers_of(arch)), tree)
    inputs, out, script = tmp / "inputs.pkl", tmp / "results.json", tmp / "mesh_ranks.py"
    with open(inputs, "wb") as f:
        pickle.dump({"trees": trees, "ckpt": ckpt, "train": list(archs), "serve": list(serve),
                     "jax_serve": jax_serve, "f32_tol": F32_TOL, "quantize": quantize,
                     "decode": _decode_inputs() if decode else []}, f)
    script.write_text(SCRIPT)
    r = subprocess.run(
        [sys.executable, str(script), str(inputs), str(out)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"},
        cwd=ROOT, timeout=300, capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-8000:]
    with open(out, "rb") as f:
        return pickle.load(f)
