"""Quickstart on the PyTorch port: the CORE primitive in 60 seconds.

The twin of examples/quickstart.py on ``repro_torch``: encodes t objects
with the (n,k,t) product code, kills blocks, repairs them three ways
(classic HDFS-RAID RS, optimized RS, CORE vertical/RGS), and prints the
paper's headline numbers live. The codec runs on the card (the GF(256)
product and the XOR parity kernels); ``--device cpu`` runs their plain
torch versions on the host.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.product_code import CoreCode, CoreCodec
from repro_torch.kernels.backend import resolve_device
from repro_torch.storage.blockstore import BlockStore
from repro_torch.storage.netmodel import ClusterProfile
from repro_torch.storage.repair import BlockFixer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    device = str(resolve_device(ap.parse_args(argv).device))

    code = CoreCode(n=9, k=6, t=3)
    codec = CoreCodec(code, device=device)
    rng = np.random.default_rng(0)
    block = 1 << 18  # 256 KiB

    print(f"CORE ({code.n},{code.k},{code.t}): stretch {code.stretch:.2f}x")
    objects = rng.integers(0, 256, (code.t, code.k, block), dtype=np.uint8)
    matrix = codec.encode(objects).cpu().numpy()
    print(f"encoded {code.t} objects -> {code.rows}x{code.n} block matrix "
          f"({matrix.nbytes / 1e6:.1f} MB)")
    assert codec.verify(matrix), "product-code consistency"

    for mode in ("hdfs_raid", "hdfs_raid_opt", "core"):
        store = BlockStore(num_nodes=20)
        store.put_group("demo", matrix)
        store.drop_block(("demo", 0, 0))  # single failure
        fixer = BlockFixer(store, code, ClusterProfile.network_critical(), mode=mode,
                           device=device)
        rep = fixer.fix_group("demo")
        ok = np.array_equal(store.get(("demo", 0, 0)), matrix[0, 0])
        print(f"  {mode:15s} fetched {rep.blocks_fetched:2d} blocks "
              f"({rep.bytes_fetched/1e6:5.1f} MB), "
              f"t_net {rep.network_time:6.2f}s + t_cpu {rep.compute_time:5.3f}s "
              f"verified={ok}")

    # a failure pattern classic RS cannot recover at all: 4 failures in one row
    store = BlockStore(num_nodes=20)
    store.put_group("demo", matrix)
    for c in range(4):
        store.drop_block(("demo", 1, c))  # > n-k = 3 failures in the row
    fixer = BlockFixer(store, code, ClusterProfile.network_critical(), mode="core",
                       device=device)
    rep = fixer.fix_group("demo")
    ok = all(np.array_equal(store.get(("demo", 1, c)), matrix[1, c]) for c in range(4))
    print(f"4 failures in one row (unrecoverable for a row-only (9,6) RS): "
          f"CORE repairs via vertical parity, verified={ok}, "
          f"schedule [{rep.schedule}]")


if __name__ == "__main__":
    main()
