"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

#: dense bfloat16 tensor-core rate
BF16_FLOPS_PER_S = 989e12
#: HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12
