"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates without sparsity, at the full 700 W power limit)."""

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
