from repro_torch.checkpoint.core_ckpt import CheckpointManifest, CoreCheckpointer
from repro_torch.checkpoint import partition

__all__ = ["CheckpointManifest", "CoreCheckpointer", "partition"]
