"""SeamlessM4T-large-v2 transformer backbone (enc-dec).
[arXiv:2308.11596; hf]
Modality frontend is a STUB: input_specs() provides precomputed speech
frame embeddings (B, T_frames, d_model). 24 encoder + 24 decoder layers."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=48,  # 24 enc + 24 dec
    enc_layers=24,
    dec_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    num_stub_tokens=1024,  # precomputed audio frame embeddings
    norm="layernorm",
    act="gelu",
    use_rope=False,  # sinusoidal absolute positions (NLLB lineage)
)
