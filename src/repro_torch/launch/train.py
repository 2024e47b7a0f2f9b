"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

    python -m repro_torch.launch.train --arch olmoe_1b_7b [--reduced] \\
        [--steps 200 --seq-len 256 --global-batch 8 --ckpt-every 50] \\
        [--quantize-v] [--device cuda|cpu] [--seed 0]

The single-process engine (train/loop.py) on one device: the card by
default, raising without one; ``--device cpu`` runs the plain torch path
on the host. The CORE checkpoint layer is always on. ``--arch`` takes
every id of the JAX package (the ssm, dense, vlm, moe, hybrid and
encdec families; the encdec batches carry the pipeline's ``src_embed``
frames). The reference's ``--mesh`` and ``--devices`` raise
``NotImplementedError``: they wait for the mesh slice (ROADMAP queue 1).
Ends with ``done at step N; final loss X``.
"""

from __future__ import annotations

import argparse
import sys


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
    ap.add_argument("--mesh", default=None, help="not ported yet (the mesh slice)")
    ap.add_argument("--devices", type=int, default=None,
                    help="not ported yet (the mesh slice)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quantize-v", action="store_true",
                    help="int8 blockwise second moment (8-bit optimizer)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh or args.devices:
        raise NotImplementedError(
            "--mesh / --devices wait for the mesh slice (ROADMAP queue 1); "
            "the port trains on one device")

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

    trainer = Trainer(cfg, lc, oc, device=args.device)
    state = trainer.run()
    print(f"done at step {int(state.step)}; "
          f"final loss {trainer.metrics_log[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
