"""StarCoder2-15B (dense, GQA kv=4, RoPE, gelu MLP, biases).
[arXiv:2402.19173; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=1e5,
    qkv_bias=True,
    norm="layernorm",
    act="gelu",  # classic 2-matrix MLP
    sliding_window=4096,
)
