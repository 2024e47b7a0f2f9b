"""End-to-end training run with CORE-protected fault tolerance, on the
PyTorch port (the twin of examples/train_tiny_lm.py on ``repro_torch``).

Trains a small decoder LM (reduced qwen2 wiring; --big trains a ~100M
variant) on the synthetic pipeline with CORE-encoded checkpoints, then
demonstrates the paper's value proposition *inside a training job*:

  1. train N steps, checkpointing every K;
  2. KILL storage nodes (simulated host loss) so checkpoint blocks die;
  3. DEGRADED RESTORE straight through the failures (vertical XOR path);
  4. verify the restored train state bit-for-bit (paper §7.3's MD5
     check, done with sha256 here);
  5. background-repair the lost blocks (RGS schedule) and keep training.

Training and the checkpoint codec run on the card; ``--device cpu``
runs them on the host.

    PYTHONPATH=src python examples/torch_train_tiny_lm.py [--big] [--steps 300] [--device cpu]
"""

import argparse
import hashlib

from repro_torch.checkpoint import partition
from repro_torch.configs import get_config
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import convert
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts
from repro_torch.train.loop import LoopConfig, Trainer


def state_digest(state) -> str:
    """sha256 of the state's leaves in the reference's order (the stacked
    parameters, the optimizer state, the step), each leaf's raw bytes."""
    tree = ts.TrainState(convert.stacked_tree(state.params), state.opt, state.step)
    return hashlib.sha256(partition.tree_to_stream(tree)[0]).hexdigest()[:16]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--big", action="store_true",
                    help="~100M params (slow on CPU; the deliverable profile)")
    ap.add_argument("--kill-nodes", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))

    cfg = get_config("qwen2_72b").reduced()
    if args.big:
        cfg = cfg.reduced(num_layers=8, d_model=768, num_heads=12, head_dim=64,
                          d_ff=2048, vocab_size=32768)

    lc = LoopConfig(steps=args.steps, ckpt_every=max(args.steps // 3, 10),
                    log_every=10, seq_len=128, global_batch=8)
    oc = opt.OptConfig(lr=1e-3, warmup_steps=10, decay_steps=args.steps)
    tr = Trainer(cfg, lc, oc, device=device)
    n_params = sum(p.numel() for p in ts.state_shape(cfg, tr.api, oc).params.parameters())
    print(f"arch={cfg.name} (reduced) params={n_params/1e6:.1f}M "
          f"core_code=({tr.ckpt.code.n},{tr.ckpt.code.k},{tr.ckpt.code.t})")

    # phase 1: train with periodic CORE checkpoints
    state = tr.run()
    d0 = state_digest(state)
    first, last = tr.metrics_log[0]["loss"], tr.metrics_log[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({'LEARNING' if last < first else 'no improvement?'})")
    print(f"final-state digest {d0}")

    # phase 2: kill storage nodes; checkpoint blocks on them are gone
    victims = list(range(args.kill_nodes))
    tr.store.fail_nodes(victims)
    lost = sum(1 for k, n in tr.store.placement.items() if n in victims)
    print(f"\nkilled nodes {victims} -> {lost} checkpoint blocks unavailable")

    # phase 3+4: degraded restore through the failures, verify digest
    restored = tr.restore_latest()
    rep = tr.last_restore_report
    d1 = state_digest(restored)
    print(f"degraded restore: fetched {rep.blocks_fetched} blocks "
          f"({rep.bytes_fetched/1e6:.1f} MB), digest {d1} "
          f"{'== OK' if d1 == d0 else '!= CORRUPT'}")
    assert d1 == d0

    # phase 5: background repair regenerates the lost blocks onto the
    # surviving nodes while the victims are still dead, then train on
    fix = tr.ckpt.repair(int(restored.step))
    print(f"background repair: {fix.blocks_repaired} blocks regenerated "
          f"(schedules [{fix.schedule[:60]}…]), fetched {fix.blocks_fetched} blocks")
    for n in victims:
        tr.store.heal_node(n)  # replacement hosts may rejoin later

    tr.lc.steps = args.steps + 30
    state = tr.run(state=restored, until=args.steps + 30)
    print(f"\nresumed to step {int(state.step)}; "
          f"loss {tr.metrics_log[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
