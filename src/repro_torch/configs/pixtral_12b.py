"""Pixtral-12B language backbone (pixtral-ViT frontend is a STUB:
input_specs() provides precomputed patch embeddings).
[hf:mistralai/Pixtral-12B-2409; unverified]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e9,
    num_stub_tokens=256,  # precomputed image patch embeddings
    act="silu",
)
