"""The least time of one call of the work a roofline share is taken of: the
larger of its operations over the peak rate and its bytes over the memory
bandwidth, each input byte read once and each output byte written once.

- ``ringconv``: a 3x3 ring conv of x (B, H, W, C_in) into (B, H, W, F) on the
  tensor cores: 2 * 9 * C_in * F * B * H * W operations; x in, y out, the
  weight (9 C_in F) in bf16 and the fp32 bias.
- ``group_norm``: GroupNorm (+ affine, + SiLU) of x: x in and y out, about 10
  fp32 operations an element off the tensor cores.
"""

from __future__ import annotations

from . import PEAK_BF16_FLOPS, PEAK_BYTES


def ringconv(B: int, H: int, W: int, C: int, F: int, in_bytes: int = 2, out_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes)."""
    return 2.0 * 9 * C * F * B * H * W, float(B * H * W * (C * in_bytes + F * out_bytes) + 9 * C * F * 2 + F * 4)


def group_norm(numel: int, in_bytes: int = 2, out_bytes: int = 2) -> tuple[float, float]:
    return 10.0 * numel, float(numel * (in_bytes + out_bytes))


def least_seconds(ops: float, nbytes: float, peak_ops: float = PEAK_BF16_FLOPS) -> float:
    return max(ops / peak_ops, nbytes / PEAK_BYTES)

