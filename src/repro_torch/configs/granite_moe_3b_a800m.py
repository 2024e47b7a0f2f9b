"""IBM Granite-3.0 3B-A800M MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
Assigned config line says "MoE 40e top-8" with a trailing "32 experts"
note; we follow the config field (40 experts, top-8) and record the
discrepancy here. 40 % 16 != 0 -> experts replicated, TP inside the
(d_ff=512) expert MLPs (DESIGN.md §5)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,  # per-expert hidden
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    act="silu",
    tie_embeddings=True,
)
