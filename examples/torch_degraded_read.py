"""Degraded reads under node failures on the PyTorch port: CORE vs
classic RS on the simulated cluster, the paper's §5.3 trade-offs, live
(the twin of examples/degraded_read.py on ``repro_torch``):

  * single-BLOCK degraded access: CORE pulls t blocks (vertical XOR),
    RS pulls k (decode), the paper's headline win;
  * whole-OBJECT centralized read with one failure: CORE pays
    (k-1) + t vs RS's k, the honest Fig-7 overhead at low stretch;
  * three failures in one row: (14,12) RS is DEAD (> n-k), CORE
    reads through via the vertical parities.

The codec and the repairs run on the card; ``--device cpu`` runs the
kernels' plain torch versions on the host.

    PYTHONPATH=src python examples/torch_degraded_read.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.product_code import CoreCode, CoreCodec
from repro_torch.kernels.backend import resolve_device
from repro_torch.storage.blockstore import BlockStore
from repro_torch.storage.netmodel import ClusterProfile
from repro_torch.storage.repair import BlockFixer, UnrecoverableError


def fresh(code, matrix, drop):
    store = BlockStore(num_nodes=20)
    store.put_group("obj", matrix)
    for cell in drop:
        store.drop_block(("obj", *cell))
    return store


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    device = str(resolve_device(ap.parse_args(argv).device))

    code = CoreCode(14, 12, 5)
    codec = CoreCodec(code, device=device)
    rng = np.random.default_rng(1)
    block = 1 << 18
    objects = rng.integers(0, 256, (code.t, code.k, block), dtype=np.uint8)
    matrix = codec.encode(objects).cpu().numpy()
    prof = ClusterProfile.network_critical()

    print("1) single-BLOCK degraded access (block (0,0) missing)")
    for mode in ("hdfs_raid", "core"):
        store = fresh(code, matrix, [(0, 0)])
        fixer = BlockFixer(store, code, prof, mode=mode, device=device)
        rep = fixer.fix_group("obj")  # regenerate just the missing block
        print(f"   {mode:10s} fetched {rep.blocks_fetched:2d} blocks "
              f"({rep.bytes_fetched/1e6:5.1f} MB) t={rep.total_time:5.2f}s")
    print(f"   -> CORE: t={code.t} blocks vs RS: k={code.k} (paper's 50%+ save)\n")

    print("2) whole-OBJECT centralized read, one block missing "
          "(paper Fig 7: CORE pays extra at low stretch)")
    for mode in ("hdfs_raid", "core"):
        store = fresh(code, matrix, [(0, 0)])
        fixer = BlockFixer(store, code, prof, mode=mode, device=device)
        data, rep = fixer.degraded_read("obj", row=0)
        ok = np.array_equal(data, matrix[0, : code.k])
        print(f"   {mode:10s} fetched {rep.blocks_fetched:2d} blocks "
              f"({rep.bytes_fetched/1e6:5.1f} MB) t={rep.total_time:5.2f}s ok={ok}")
    print()

    print("3) three failures in row 0 (> n-k = 2): RS cannot read at all")
    for mode in ("hdfs_raid", "core"):
        store = fresh(code, matrix, [(0, 0), (0, 1), (0, 2)])
        fixer = BlockFixer(store, code, prof, mode=mode, device=device)
        try:
            data, rep = fixer.degraded_read("obj", row=0)
            ok = np.array_equal(data, matrix[0, : code.k])
            print(f"   {mode:10s} fetched {rep.blocks_fetched:2d} blocks, ok={ok}")
        except UnrecoverableError as e:
            print(f"   {mode:10s} UNRECOVERABLE ({e})")


if __name__ == "__main__":
    main()
