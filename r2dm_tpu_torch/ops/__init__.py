"""Tensor ops of the port: padding, FIR resampling, encodings, and the
hand-written CUDA kernels (``gn_silu``, ``act_ringconv``, and the int8
lane's ``w8a8_ringconv``: its absmax reduction, its quantize pass and its
s8 conv), with the cross-rank forms the width axis runs (the ring conv's
halo'd form, GroupNorm's stats and apply launches, the quantize pass's
halo'd form)."""

from .act_ringconv import act_ringconv_halo, fused_act_ringconv
from .gn_silu import fused_group_norm_silu, gn_apply, gn_stats
from .quant import act_absmax, act_quantize, act_quantize_halo, ring_conv_w8a8

# every wrapper that launches a CUDA kernel; each counts its launches (its
# calls: one into a CUDA graph's capture records the kernel, and a replay
# of that graph runs it with no call)
KERNEL_WRAPPERS = (fused_group_norm_silu, fused_act_ringconv, ring_conv_w8a8, act_absmax, act_quantize,
                   act_ringconv_halo, gn_stats, gn_apply, act_quantize_halo)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        if hasattr(fn, "tile_launches"):  # the ring conv's, by tile variant
            fn.tile_launches = dict.fromkeys(fn.tile_launches, 0)
