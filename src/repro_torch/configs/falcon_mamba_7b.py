"""Falcon-Mamba-7B (attention-free Mamba-1 SSM).
[arXiv:2410.05355; unverified]
d_inner = 2 * d_model = 8192, ssm_state = 16, conv4, dt_rank = 256."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    d_conv=4,
    expand=2,
    dt_rank=256,
    tie_embeddings=True,
)
