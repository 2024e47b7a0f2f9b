"""Serving launcher: greedy continuous-batching decode over synthetic
prompts with the SlotManager (serve/kvcache.py), on the card.

    python -m repro_torch.launch.serve --arch falcon_mamba_7b [--reduced] \\
        [--requests 8 --batch 4 --prompt-len 32 --max-new 16 --cache-len 128] \\
        [--device cuda|cpu] [--seed 0]

Weights are drawn from ``--seed`` on the device, prompts from a numpy
generator with the same seed. The default device is the card; without
one the launcher raises (``--device cpu`` runs the plain torch path).
Every id of the JAX package serves. An encdec id decodes against
``init_cache``'s zero cross-attention memory and never runs its encoder,
as the reference's launcher does. Prints the requests served, the tokens
generated and the wall time.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.backend import resolve_device, synchronize
from repro_torch.models.registry import get_model
from repro_torch.models.shardings import SINGLE, ServePlan
from repro_torch.serve.kvcache import Request, SlotManager
from repro_torch.serve.serve_step import greedy_sample, make_decode_step


def serve_requests(api, params, cfg, prompts, *, batch: int, max_new: int,
                   cache_len: int) -> list[Request]:
    """The reference launcher's loop (src/repro/launch/serve.py), on
    ``params``' device: admit requests into free slots, feed each
    admitted prompt but its last token through the batched decode (the
    other slots take token 0, which advances their state too, as in the
    reference), then decode greedily until every request is done.
    Returns the finished requests in finishing order."""
    mgr = SlotManager(batch=batch, cache_len=cache_len)
    for rid, prompt in enumerate(prompts):
        mgr.submit(Request(rid, np.asarray(prompt, np.int32), max_new))
    device = params.device
    cache = api.init_cache(cfg, batch, cache_len, device=device)
    decode = make_decode_step(cfg, api, SINGLE, ServePlan())

    def prefill_into_slot(slot: int, req: Request, cache):
        """Prefill one request's prompt through the decode path (keeps
        the shared batched cache layout slot-aligned)."""
        for j, t in enumerate(req.prompt[:-1]):
            tok = np.zeros((batch, 1), np.int32)
            tok[slot, 0] = t
            _, cache = decode(params, cache, torch.from_numpy(tok).to(device), j)
        return cache

    step = 0
    limit = len(prompts) * (max_new + max((len(p) for p in prompts), default=0)) + 100
    while mgr.live or mgr.waiting:
        for slot, req in mgr.admit():
            cache = prefill_into_slot(slot, req, cache)
        tok = torch.from_numpy(mgr.step_tokens()).to(device)
        pos = int(mgr.pos.max() - 1) if mgr.pos.max() else 0
        logits, cache = decode(params, cache, tok, pos)
        mgr.record(greedy_sample(logits)[:, 0].cpu().numpy())
        step += 1
        if step > limit:
            break
    return mgr.finished


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    help="an id of repro_torch.configs.ARCH_IDS (every family, e.g. "
                         "falcon_mamba_7b, qwen2_72b, recurrentgemma_9b, seamless_m4t_large_v2)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = get_model(cfg)
    params = api.init(cfg, args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.requests, args.prompt_len), dtype=np.int32)

    t0 = time.perf_counter()
    finished = serve_requests(api, params, cfg, prompts, batch=args.batch,
                              max_new=args.max_new, cache_len=args.cache_len)
    synchronize(device)
    dt = time.perf_counter() - t0
    print(f"served {len(finished)} requests, "
          f"{sum(len(r.generated) for r in finished)} tokens "
          f"in {dt:.2f}s on {device}")
    for r in finished[:4]:
        print(f"  req {r.rid}: {r.generated[:8]}…")
    return 0


if __name__ == "__main__":
    sys.exit(main())
