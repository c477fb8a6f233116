"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet, dense
rates, at the full 700 W power limit; the run records the card's limit)."""

BF16_FLOPS = 989e12      # bf16 / fp16 tensor cores, FLOP/s
F32_FLOPS = 67e12        # f32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12      # HBM3, B/s
