"""Tensor ops of the port: padding, FIR resampling, encodings, and the two
hand-written CUDA kernels (``gn_silu``, ``act_ringconv``)."""

from .act_ringconv import fused_act_ringconv
from .gn_silu import fused_group_norm_silu

# every wrapper that launches a CUDA kernel; each counts its launches
KERNEL_WRAPPERS = (fused_group_norm_silu, fused_act_ringconv)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0

