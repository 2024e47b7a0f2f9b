"""Config registry: --arch <id> resolves here. The ids are the JAX
package's, and the port serves and trains every one of them."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, CoreCodeCfg, ShapeCell

ARCH_IDS = [
    "mistral_large_123b",
    "command_r_35b",
    "starcoder2_15b",
    "qwen2_72b",
    "recurrentgemma_9b",
    "granite_moe_3b_a800m",
    "olmoe_1b_7b",
    "falcon_mamba_7b",
    "seamless_m4t_large_v2",
    "pixtral_12b",
]
PORTED = list(ARCH_IDS)  # every family: ssm, dense, vlm, moe, hybrid, encdec


def get_config(arch: str) -> ArchConfig:
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


__all__ = ["ARCH_IDS", "ArchConfig", "CoreCodeCfg", "SHAPES", "ShapeCell", "get_config"]
