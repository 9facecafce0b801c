"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). Every roofline and MFU
share of the benchmark is taken against these numbers."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12          # tensor cores, bf16 and fp16
TF32_FLOP_PER_S = 495e12          # tensor cores, TF32
FP32_FLOP_PER_S = 67e12           # CUDA cores, float32
