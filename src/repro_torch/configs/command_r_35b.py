"""Cohere Command-R 35B (dense, GQA, no-bias).
[hf:CohereForAI/c4ai-command-r-v01; unverified]
Note: the HF model uses parallel attn+MLP blocks and tied embeddings; we
keep the standard sequential residual wiring (backbone-equivalent FLOPs)
and tie embeddings."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    rope_theta=8e6,
    norm="layernorm",
    tie_embeddings=True,
    act="silu",
)
