"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W power limit)."""

PEAK_BF16_FLOPS = 989e12   # bf16 / fp16 tensor cores
PEAK_BYTES = 3.35e12       # HBM3
