from repro_torch.storage.blockstore import BlockKey, BlockStore, PlacementError
from repro_torch.storage.netmodel import (
    BACKGROUND,
    FOREGROUND,
    FOREGROUND_TENANT,
    REPAIR_TENANT,
    ClusterProfile,
    NetSimulator,
    Transfer,
    base_tenant,
    shard_tenant,
)
from repro_torch.storage.repair import BlockFixer, RepairReport, UnrecoverableError

__all__ = [
    "BlockKey",
    "BlockStore",
    "PlacementError",
    "BACKGROUND",
    "FOREGROUND",
    "FOREGROUND_TENANT",
    "REPAIR_TENANT",
    "ClusterProfile",
    "NetSimulator",
    "Transfer",
    "base_tenant",
    "shard_tenant",
    "BlockFixer",
    "RepairReport",
    "UnrecoverableError",
]
