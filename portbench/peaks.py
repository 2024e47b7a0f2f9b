"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; copied from
``repro_torch.analysis.roofline.H100_SXM``): HBM3 bandwidth and dense
bf16 tensor-core rate, at the card's full 700 W power limit."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989.4e12
