"""GroupNorm (+ affine) (+ SiLU) on NHWC activations: the CUDA kernel
``csrc/gn_silu.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``r2dm_tpu/ops/pallas_gn.py::fused_group_norm_silu``.
Two entries:

- ``gn_coeffs(x, G, eps, gain, shift) -> (a, b)``: fp32 (B, C) coefficients
  with GN_affine(x) == x*a + b (statistics phase + fold). ``ResidualBlock``
  feeds them to the conv prologue of ``act_ringconv``.
- ``fused_group_norm_silu(x, gain, shift, G, eps, apply_silu)``: the TPU
  kernel's whole function, used by ``SelfAttentionBlock``'s norm.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_ARGS_COEFFS = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
)
_ARGS_SILU = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)
_TARGET_BLOCKS = 1056  # 8 statistics blocks per SM of an H100 SXM (132 SMs)
_MAX_C = 2048


def _lib():
    lib = build.load("gn_silu")
    if lib.gn_coeffs_launch.argtypes is None:
        lib.gn_coeffs_launch.argtypes = _ARGS_COEFFS
        lib.gn_coeffs_launch.restype = ctypes.c_int
        lib.gn_silu_launch.argtypes = _ARGS_SILU
        lib.gn_silu_launch.restype = ctypes.c_int
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


def _launch_args(x, num_groups, gain, shift):
    """(partial workspace, gain, shift, gstride, rows_per_chunk, nchunks)."""
    B, H, W, C = x.shape
    if gain.dim() != shift.dim():
        gain, shift = _affine(gain, shift, B, C)
    gain = gain.to(torch.float32).contiguous()
    shift = shift.to(torch.float32).contiguous()
    gstride = C if gain.dim() == 2 else 0
    HW = H * W
    rpp = 256 // (C // 8)
    per_sample = max(1, -(-_TARGET_BLOCKS // B))
    rows = max(rpp, -(-HW // per_sample))
    rows = -(-rows // rpp) * rpp
    nchunks = -(-HW // rows)
    partial = torch.empty((B, nchunks, 2, C), dtype=torch.float32, device=x.device)
    return partial, gain, shift, gstride, rows, nchunks


def gn_coeffs(x, num_groups: int, eps: float, gain, shift):
    """fp32 (a, b) of shape (B, C) with GN_affine(x) == x*a + b; x NHWC,
    gain/shift (C,) or (B, C)."""
    if x.device.type == "cpu":
        return gn_coeffs_plain(x, num_groups, eps, gain, shift)
    _check(x, num_groups, gain, shift)
    lib = _lib()
    B, H, W, C = x.shape
    partial, gain, shift, gstride, rows, nchunks = _launch_args(x, num_groups, gain, shift)
    a = torch.empty((B, C), dtype=torch.float32, device=x.device)
    b = torch.empty_like(a)
    rc = lib.gn_coeffs_launch(
        x.data_ptr(), partial.data_ptr(), gain.data_ptr(), shift.data_ptr(), gstride,
        a.data_ptr(), b.data_ptr(), B, H * W, C, num_groups, rows, nchunks,
        float(eps), build.stream_ptr(x.device),
    )
    build.check(lib, rc, "gn_coeffs")
    gn_coeffs.launches += 1
    return a, b


gn_coeffs.launches = 0


def fused_group_norm_silu(x, gain, shift, num_groups: int, eps: float, apply_silu: bool = True):
    """[silu](GN(x) * gain + shift) on NHWC x; gain/shift (C,) or (B, C)."""
    if x.device.type == "cpu":
        return fused_group_norm_silu_plain(x, gain, shift, num_groups, eps, apply_silu)
    _check(x, num_groups, gain, shift)
    lib = _lib()
    B, H, W, C = x.shape
    partial, gain, shift, gstride, rows, nchunks = _launch_args(x, num_groups, gain, shift)
    a = torch.empty((B, C), dtype=torch.float32, device=x.device)
    b = torch.empty_like(a)
    y = torch.empty_like(x)
    n_vec = x.numel() // 8
    apply_blocks = max(1, min(-(-n_vec // 256), 132 * 16))
    rc = lib.gn_silu_launch(
        x.data_ptr(), partial.data_ptr(), gain.data_ptr(), shift.data_ptr(), gstride,
        a.data_ptr(), b.data_ptr(), y.data_ptr(), B, H * W, C, num_groups, rows,
        nchunks, float(eps), int(apply_silu), apply_blocks, build.stream_ptr(x.device),
    )
    build.check(lib, rc, "fused_group_norm_silu")
    fused_group_norm_silu.launches += 1
    return y


fused_group_norm_silu.launches = 0
