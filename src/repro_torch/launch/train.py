"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

    python -m repro_torch.launch.train --arch olmoe_1b_7b [--reduced] \\
        [--steps 200 --seq-len 256 --global-batch 8 --ckpt-every 50] \\
        [--quantize-v] [--device cuda|cpu] [--seed 0] [--mesh 2x2 [--devices 4]]

The engine (train/loop.py) on one device: the card by default, raising
without one; ``--device cpu`` runs the plain torch path on the host. The
CORE checkpoint layer is always on. ``--arch`` takes every id of the JAX
package (the ssm, dense, vlm, moe, hybrid and encdec families; the
encdec batches carry the pipeline's ``src_embed`` frames).

``--mesh DxM`` (or ``PxDxM``; axes (data, model) or (pod, data, model))
trains sharded on that mesh: the launcher spawns one rank process per
mesh position (``--devices``, if given, must equal the mesh's size).
The ranks meet through a ``file://`` rendezvous in a temporary
directory: NCCL on the card, one rank per card (more ranks than cards
raise ValueError), gloo with ``--device cpu``. A rank that dies fails
the others within ``RANK_TIMEOUT_S`` seconds. ``--quantize-v`` on a mesh
keeps the int8 second moment replicated on every rank, as the
reference's ``opt_specs`` does. ``--devices`` alone builds no mesh, as in
the reference. Only rank 0 prints; the run ends with ``done at step N;
final loss X``.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

# how long a rank waits for the others in a collective before it fails
RANK_TIMEOUT_S = 300.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    help="an id of repro_torch.configs.ARCH_IDS (every family, e.g. "
                         "falcon_mamba_7b, qwen2_72b, recurrentgemma_9b, seamless_m4t_large_v2)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-sized sibling of --arch (CPU-friendly)")
    ap.add_argument("--mesh", default=None, help='e.g. "2x2": axes (data, model)')
    ap.add_argument("--devices", type=int, default=None,
                    help="rank processes (default: the mesh's size)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quantize-v", action="store_true",
                    help="int8 blockwise second moment (8-bit optimizer)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh is None:  # as in the reference, --devices alone builds no mesh
        return _train(args)
    dims = tuple(int(x) for x in args.mesh.split("x"))
    world = args.devices or math.prod(dims)
    if world != math.prod(dims):
        raise ValueError(f"--mesh {args.mesh} takes {math.prod(dims)} ranks, not --devices {world}")
    if (args.device or "cuda").startswith("cuda"):
        import torch

        if world > torch.cuda.device_count():
            raise ValueError(f"{world} ranks need {world} cards (NCCL takes one rank per "
                             f"card); this host has {torch.cuda.device_count()}")
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro-rdv-") as tmp:
        rdv = "file://" + os.path.join(tmp, "rendezvous")
        mp.spawn(_rank_main, args=(world, rdv, dims, args), nprocs=world, join=True)
    return 0


def _rank_main(rank: int, world: int, rdv: str, dims: tuple, args) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks, make_mesh

    if args.device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    init_ranks(rank, world, rdv, args.device, RANK_TIMEOUT_S)
    try:
        axes = ("pod", "data", "model")[-len(dims):]
        _train(args, make_mesh(dims, axes, device=args.device), quiet=rank != 0)
    finally:
        dist.destroy_process_group()


def _train(args, mesh=None, quiet: bool = False) -> int:
    from repro_torch.configs import get_config
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import LoopConfig, Trainer

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    lc = LoopConfig(
        steps=args.steps, ckpt_every=args.ckpt_every, log_every=args.log_every,
        seq_len=args.seq_len, global_batch=args.global_batch, seed=args.seed,
    )
    oc = opt.OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
                       decay_steps=args.steps, quantize_v=args.quantize_v)

    trainer = Trainer(cfg, lc, oc, mesh=mesh, device=args.device)
    state = trainer.run()
    step = state.step.full_tensor() if mesh is not None else state.step
    if not quiet:
        print(f"done at step {int(step)}; "
              f"final loss {trainer.metrics_log[-1]['loss']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
