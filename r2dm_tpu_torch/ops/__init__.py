"""Tensor ops of the port: padding, FIR resampling, encodings, and the
hand-written CUDA kernels (``gn_silu``, ``act_ringconv``, and the int8
lane's ``w8a8_ringconv``: its absmax reduction, its quantize pass and its
s8 conv)."""

from .act_ringconv import fused_act_ringconv
from .gn_silu import fused_group_norm_silu
from .quant import act_absmax, act_quantize, ring_conv_w8a8

# every wrapper that launches a CUDA kernel; each counts its launches
KERNEL_WRAPPERS = (fused_group_norm_silu, fused_act_ringconv, ring_conv_w8a8, act_absmax, act_quantize)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0

