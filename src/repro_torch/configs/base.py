"""Architecture configuration schema + registry.

One config file per ported architecture lives in this package; each
exposes ``CONFIG``. ``--arch <id>`` in the launchers resolves through
``repro_torch.configs.get_config``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class CoreCodeCfg:
    """CORE protection level for this arch's checkpoints (paper §4)."""

    n: int = 14
    k: int = 12
    t: int = 5


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    use_rope: bool = True
    rope_theta: float = 1e4
    qkv_bias: bool = False
    sliding_window: int | None = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu (gated) | gelu (non-gated, classic 2-matrix MLP)
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba-1)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0

    # hybrid (recurrentgemma): repeating block pattern, e.g. ("rec","rec","attn")
    block_pattern: tuple[str, ...] = ()
    lru_width: int = 0

    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0

    # modality stub (audio frames / vision patches), prepended embeddings
    num_stub_tokens: int = 0

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    core_code: CoreCodeCfg = field(default_factory=CoreCodeCfg)

    # training-time knobs (overridable per run)
    microbatches: int = 1
    attn_chunk: int = 512
    scan_chunk: int = 128  # ssm/rglru chunked-scan length
    remat_block: int = 0  # two-level remat group size (0 = per-layer only)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test-sized sibling: same family/wiring, tiny dims."""
        small = dict(
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads > 1 else 1,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            num_experts=8 if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.num_experts else 0,
            ssm_state=8 if self.ssm_state else 0,
            dt_rank=8 if self.ssm_state else 0,
            lru_width=128 if self.lru_width else 0,
            sliding_window=64 if self.sliding_window else None,
            enc_layers=2 if self.enc_layers else 0,
            dec_layers=2 if self.dec_layers else 0,
            num_stub_tokens=8 if self.num_stub_tokens else 0,
            block_pattern=self.block_pattern,
            attn_chunk=32,
            scan_chunk=16,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# shape cells assigned to the LM pool --------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}
