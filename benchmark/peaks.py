"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit)."""

PEAK_BF16_FLOPS = 989e12      # dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12          # HBM3 bytes a second
