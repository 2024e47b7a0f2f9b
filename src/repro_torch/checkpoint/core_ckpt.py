"""CORE-encoded distributed checkpointing — the paper's primitive as the
resilience layer of training state.

Save: tree -> byte stream -> k-block objects -> t-object CORE groups ->
RS(n,k) horizontal + XOR vertical encode -> anti-colocated placement in
the block store.

Restore: per group, degraded reads of the systematic blocks (vertical
XOR repair for singleton column failures, RS row decode otherwise).
Restore succeeds under any failure pattern inside the code's
recoverability envelope, host failures included — this is
checkpoint/restart for free at the storage layer.

Repair: background BlockFixer pass (RGS schedule) replenishing lost
blocks onto fresh nodes — the paper's fast repair path keeping the
"unsafe window" short.

The store is host memory; the codec and fixer arithmetic runs on
``device`` (``None``/``"cuda"`` is the card and raises without one,
``"cpu"`` the host).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.checkpoint import partition
from repro_torch.core.product_code import CoreCode, CoreCodec
from repro_torch.kernels.backend import resolve_device, synchronize
from repro_torch.storage.blockstore import BlockStore
from repro_torch.storage.netmodel import ClusterProfile
from repro_torch.storage.repair import BlockFixer, RepairReport


@dataclass
class CheckpointManifest:
    step: int
    group_ids: list[str]
    treedef: object
    leaf_specs: list
    total_bytes: int
    block_size: int
    code: CoreCode
    save_seconds: float = 0.0


@dataclass
class CoreCheckpointer:
    store: BlockStore
    code: CoreCode
    profile: ClusterProfile = field(default_factory=ClusterProfile.network_critical)
    block_size: int = 1 << 16
    scheduler: str = "rgs"
    manifests: dict[int, CheckpointManifest] = field(default_factory=dict)
    device: str | None = None

    def __post_init__(self):
        self._dev = resolve_device(self.device)
        self.codec = CoreCodec(self.code, device=self.device)

    def _fixer(self) -> BlockFixer:
        return BlockFixer(self.store, self.code, self.profile, mode="core",
                          scheduler=self.scheduler, device=self.device)

    # -- save -------------------------------------------------------------------
    def save(self, step: int, tree) -> CheckpointManifest:
        t0 = time.perf_counter()
        stream, treedef, specs = partition.tree_to_stream(tree)
        objects, pad, num_groups = partition.stream_to_objects(
            stream, self.block_size, self.code.k, self.code.t
        )
        group_ids = []
        for g in range(num_groups):
            # a writable copy: the objects view the read-only stream bytes
            matrix = self.codec.encode(objects[g].copy()).cpu().numpy()
            gid = f"ckpt-{step}-{g}"
            self.store.put_group(gid, matrix)
            group_ids.append(gid)
        synchronize(self._dev)
        manifest = CheckpointManifest(
            step=step,
            group_ids=group_ids,
            treedef=treedef,
            leaf_specs=specs,
            total_bytes=len(stream),
            block_size=self.block_size,
            code=self.code,
            save_seconds=time.perf_counter() - t0,
        )
        self.manifests[step] = manifest
        return manifest

    # -- restore ------------------------------------------------------------------
    def restore(self, step: int) -> tuple[object, RepairReport]:
        """Degraded-read restore: succeeds while every group stays inside
        the code's recoverability envelope, even with failed nodes."""
        man = self.manifests[step]
        fixer = self._fixer()
        agg = RepairReport(mode="restore")
        parts = []
        for gid in man.group_ids:
            rows = []
            for r in range(self.code.t):
                data, rep = fixer.degraded_read(gid, r)
                agg.blocks_fetched += rep.blocks_fetched
                agg.bytes_fetched += rep.bytes_fetched
                agg.network_time += rep.network_time
                agg.compute_time += rep.compute_time
                rows.append(data)
            parts.append(np.stack(rows))
        objects = np.stack(parts)  # (groups, t, k, block)
        stream = partition.objects_to_stream(objects, man.total_bytes)
        tree = partition.stream_to_tree(stream, man.treedef, man.leaf_specs)
        return tree, agg

    # -- background repair -----------------------------------------------------------
    def repair(self, step: int) -> RepairReport:
        man = self.manifests[step]
        fixer = self._fixer()
        agg = RepairReport(mode="repair")
        for gid in man.group_ids:
            rep = fixer.fix_group(gid)
            agg.blocks_fetched += rep.blocks_fetched
            agg.bytes_fetched += rep.bytes_fetched
            agg.blocks_repaired += rep.blocks_repaired
            agg.network_time = max(agg.network_time, rep.network_time)
            agg.compute_time += rep.compute_time
            agg.recovered = agg.recovered and rep.recovered
        return agg

    def latest_step(self) -> int | None:
        return max(self.manifests) if self.manifests else None
