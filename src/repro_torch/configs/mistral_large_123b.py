"""Mistral-Large-Instruct-2407 (123B dense).
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,  # GQA
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1e6,
    act="silu",
    remat_block=8,  # 88 layers of d=12288: two-level remat to fit HBM (Perf iter B)
)
