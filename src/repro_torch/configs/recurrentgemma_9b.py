"""RecurrentGemma-9B (hybrid: RG-LRU + local attention, 2:1 pattern).
[arXiv:2402.19427; unverified]
38 layers = 12 x (rec, rec, attn) + (rec, rec). MQA (kv=1), window 2048."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,  # MQA
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    sliding_window=2048,
    act="gelu_gated",
)
