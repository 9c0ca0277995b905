"""The yardstick's arithmetic: the card's published peaks, a forward's
operations (the sum of its architecture module's count), and the operations
and bytes of the work a roofline share is taken of. Computed from shapes
alone, never from a run."""

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
