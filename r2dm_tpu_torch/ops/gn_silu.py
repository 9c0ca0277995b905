"""GroupNorm (+ affine) (+ SiLU) on NHWC activations: the CUDA kernel
``csrc/gn_silu.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``r2dm_tpu/ops/pallas_gn.py::fused_group_norm_silu``.
``fused_group_norm_silu(x, gain, shift, G, eps, apply_silu)`` is one launch
of the kernel (one thread block cluster of ``CLUSTER`` CTAs per sample;
``_launch_args`` holds the arithmetic), used by every norm of the network:
with SiLU in ``ResidualBlock`` (its output feeds ``act_ringconv`` with
``apply_act=False``), without it in ``SelfAttentionBlock``.
``gn_coeffs_plain`` gives the folded fp32 (a, b) with GN_affine(x) ==
x*a + b, the coefficients of ``act_ringconv``'s prologue (``apply_act=True``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# CTAs per sample, one thread block cluster. 8 is the portable size: at 16
# only 7 clusters fit an H100 SXM at once, and b8 needs 8.
CLUSTER = 8
THREADS = 512  # per CTA, kThreads of csrc/gn_silu.cu
_MAX_C = 2048


class Launch(NamedTuple):
    cluster: int  # K
    rows_per_cta: int  # CTA rank r takes pixel rows [r*rows, min((r+1)*rows, H*W))
    threads_per_row: int  # C/8: one 16-byte vector of 8 channels a thread
    rows_per_pass: int  # THREADS // threads_per_row
    smem_bytes: int  # dynamic shared memory: 2*rows_per_pass*C + 2*C fp32


def _lib():
    lib = build.load("gn_silu")
    if lib.gn_launch.argtypes is None:
        lib.gn_launch.argtypes = _ARGS
        lib.gn_launch.restype = ctypes.c_int
        lib.gn_max_active_clusters.argtypes = [ctypes.c_int] * 2
        lib.gn_max_active_clusters.restype = ctypes.c_int
    return lib


# ----------------------------------------------------------------- plain
def _affine(gain, shift, B, C):
    g = gain.to(torch.float32)
    s = shift.to(torch.float32)
    if g.dim() == 1:
        g = g[None]
    if s.dim() == 1:
        s = s[None]
    return g.expand(B, C), s.expand(B, C)


def gn_coeffs_plain(x, num_groups: int, eps: float, gain, shift):
    """fp32 (a, b), GN_affine(x) == x*a + b: fp32 sums of x and x^2 over
    (H, W), group mean and E[x^2]-E[x]^2 clamped at 0 (models/layers.py
    group_norm_coeffs and _folded_gn_coeffs)."""
    B, H, W, C = x.shape
    G = num_groups
    xf = x.to(torch.float32)
    s1 = xf.sum(dim=(1, 2))
    s2 = (xf * xf).sum(dim=(1, 2))
    cnt = H * W * (C // G)
    g1 = s1.reshape(B, G, -1).sum(-1) / cnt
    g2 = s2.reshape(B, G, -1).sum(-1) / cnt
    var = torch.clamp(g2 - g1 * g1, min=0.0)
    inv = torch.rsqrt(var + eps)
    a = inv.repeat_interleave(C // G, dim=1)
    b = (-g1 * inv).repeat_interleave(C // G, dim=1)
    g, s = _affine(gain, shift, B, C)
    return a * g, b * g + s


def fused_group_norm_silu_plain(x, gain, shift, num_groups: int, eps: float, apply_silu: bool = True):
    """silu((x - mean_g) * rstd_g * gain + shift) in fp32, rounded to x's
    dtype once."""
    a, b = gn_coeffs_plain(x, num_groups, eps, gain, shift)
    y = x.to(torch.float32) * a[:, None, None, :] + b[:, None, None, :]
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


# ----------------------------------------------------------------- kernel
def _check(x, num_groups, gain, shift):
    if not x.is_cuda:
        raise ValueError(f"gn_silu: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"gn_silu: the CUDA kernel takes bfloat16 activations, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"gn_silu: expected a contiguous NHWC tensor, got shape {tuple(x.shape)}")
    if x.data_ptr() % 16:  # 16-byte vector loads
        raise ValueError("gn_silu: x must start on a 16-byte boundary")
    B, H, W, C = x.shape
    if C % 8 or C > _MAX_C or C % num_groups:
        raise ValueError(f"gn_silu: C={C} must be a multiple of 8 and of G={num_groups}, at most {_MAX_C}")
    for name, t in (("gain", gain), ("shift", shift)):
        if t.device != x.device:
            raise ValueError(f"gn_silu: {name} is on {t.device}, x on {x.device}")
        if tuple(t.shape) not in ((C,), (B, C)):
            raise ValueError(f"gn_silu: {name} shape {tuple(t.shape)} is neither ({C},) nor ({B}, {C})")


def _launch_args(B: int, H: int, W: int, C: int) -> Launch:
    """The kernel's launch arithmetic: a cluster of CLUSTER CTAs per sample,
    each streaming an equal share of the sample's H*W pixel rows (the last
    shares are short or empty when H*W is not a multiple of CLUSTER)."""
    tpr = C // 8
    rpp = THREADS // tpr
    rows = -(-(H * W) // CLUSTER)
    return Launch(CLUSTER, rows, tpr, rpp, 4 * (2 * rpp * C + 2 * C))


def _affine_args(x, gain, shift):
    """fp32 contiguous gain/shift and the stride of their batch axis (0 for
    a (C,) vector)."""
    B, C = x.shape[0], x.shape[-1]
    if gain.dim() != shift.dim():
        gain, shift = _affine(gain, shift, B, C)
    gain = gain.to(torch.float32).contiguous()
    shift = shift.to(torch.float32).contiguous()
    return gain, shift, (C if gain.dim() == 2 else 0)


def max_active_clusters(C: int) -> int:
    """cudaOccupancyMaxActiveClusters for the kernel's clusters at C
    channels (config H at b8 needs 8 co-resident clusters)."""
    la = _launch_args(1, 1, 1, C)
    n = _lib().gn_max_active_clusters(la.cluster, la.smem_bytes)
    if n < 0:
        build.check(_lib(), -n, "gn_max_active_clusters")
    return n


def fused_group_norm_silu(x, gain, shift, num_groups: int, eps: float, apply_silu: bool = True):
    """[silu](GN(x) * gain + shift) on NHWC x; gain/shift (C,) or (B, C)."""
    if x.device.type == "cpu":
        return fused_group_norm_silu_plain(x, gain, shift, num_groups, eps, apply_silu)
    _check(x, num_groups, gain, shift)
    lib = _lib()
    B, H, W, C = x.shape
    gain, shift, gstride = _affine_args(x, gain, shift)
    la = _launch_args(B, H, W, C)
    y = torch.empty_like(x)
    rc = lib.gn_launch(
        x.data_ptr(), y.data_ptr(), gain.data_ptr(), shift.data_ptr(), gstride,
        B, H * W, C, num_groups, la.cluster, la.rows_per_cta, la.threads_per_row,
        la.rows_per_pass, la.smem_bytes, float(eps), int(apply_silu), build.stream_ptr(x.device),
    )
    build.check(lib, rc, "fused_group_norm_silu")
    fused_group_norm_silu.launches += 1
    return y


fused_group_norm_silu.launches = 0
