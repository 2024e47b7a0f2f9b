"""OLMoE-1B-7B (64 experts, top-8). [arXiv:2409.02060; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MHA
    head_dim=128,
    d_ff=1024,  # per-expert hidden
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    act="silu",
)
