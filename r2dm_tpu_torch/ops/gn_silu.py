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

Under a width axis (``width``: a ``World`` whose width group splits each
image's columns) the statistics are sums over every rank's pixels, as GSPMD
all-reduces them in the JAX package. ``group_norm_silu_sharded`` is then two
launches with the sum across ranks between them: ``gn_stats`` (the (2, B, C) fp32 sums of x
and x^2 of this rank's pixels, folded across each cluster in rank order),
``parallel.all_reduce_sum_`` over the width group, and ``gn_apply`` (each
group folded from the summed channels in channel order with the whole
image's count, then v2's apply loop). Each counts its own launches. Their
plain versions are ``gn_coeffs_plain``'s sums split the same way. Under
autograd the split form is the ``GroupNormSiLUSharded`` function: the same
three steps forward, the summed statistics saved; its backward is
``gn_silu_backward``'s formula with the group mean and rstd from those sums
and the per-(B, C) sums of dz and dz*x all-reduced over the width group
(one (2, B, C) all-reduce) before the dx coefficients. d_gain and d_shift
are this rank's share, from its own sums of dz and dz*x with the global
mean and rstd: the trainer sums the shares over the width group, so the
all-reduced sums there would count them W times.

Under autograd (grad enabled and an operand that requires grad) the call is
the ``GroupNormSiLU`` function: its forward is the same kernel launch, its
backward ``gn_silu_backward``, fp32 PyTorch ops that recompute the group
statistics from the saved bf16 input. The JAX package differentiates the
XLA lowering of the same maths (its Pallas kernel has no VJP), so there is
no backward kernel to port; one is a later optimisation (ROADMAP).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..parallel.width import all_reduce_sum_
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


_STATS_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_APPLY_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 + [ctypes.c_int]
               + [ctypes.c_void_p])


def _lib():
    lib = build.load("gn_silu")
    if lib.gn_launch.argtypes is None:
        lib.gn_launch.argtypes = _ARGS
        lib.gn_launch.restype = ctypes.c_int
        lib.gn_stats_launch.argtypes = _STATS_ARGS
        lib.gn_stats_launch.restype = ctypes.c_int
        lib.gn_apply_launch.argtypes = _APPLY_ARGS
        lib.gn_apply_launch.restype = ctypes.c_int
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


def _channel_sums(xf):
    """(2, B, C) fp32: the sums of x and of x^2 over the pixels of fp32 x
    (B, N, C) or (B, H, W, C)."""
    dims = tuple(range(1, xf.dim() - 1))
    return torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)])


def _fold(sums, num_groups: int, cnt, eps: float):
    """Per (sample, channel) group mean and 1/sqrt(var + eps) from the
    (2, B, C) channel sums over ``cnt`` elements a group: the sums over the
    group's channels, E[x^2]-E[x]^2 clamped at 0 (models/layers.py
    group_norm_coeffs)."""
    B, C = sums.shape[1:]
    G = num_groups
    g1 = sums[0].reshape(B, G, -1).sum(-1) / cnt
    g2 = sums[1].reshape(B, G, -1).sum(-1) / cnt
    inv = torch.rsqrt(torch.clamp(g2 - g1 * g1, min=0.0) + eps)
    return g1.repeat_interleave(C // G, dim=1), inv.repeat_interleave(C // G, dim=1)


def _group_stats(xf, num_groups: int, eps: float):
    """``_fold`` of fp32 x's own channel sums."""
    return _fold(_channel_sums(xf), num_groups, xf[0].numel() // num_groups, eps)


def _coeffs(mean, inv, gain, shift):
    B, C = mean.shape
    g, s = _affine(gain, shift, B, C)
    return inv * g, (-mean * inv) * g + s


def gn_coeffs_plain(x, num_groups: int, eps: float, gain, shift):
    """fp32 (a, b), GN_affine(x) == x*a + b, from ``_group_stats``
    (models/layers.py _folded_gn_coeffs)."""
    return _coeffs(*_group_stats(x.to(torch.float32), num_groups, eps), gain, shift)


def gn_stats_plain(x):
    """The split form's statistics: (2, B, C) fp32 sums of x and x^2 over
    x's pixels."""
    return _channel_sums(x.to(torch.float32))


def gn_apply_plain(x, sums, count, gain, shift, num_groups: int, eps: float, apply_silu: bool = True):
    """The split form's apply: [silu](x*a + b) with (a, b) folded from the
    (2, B, C) ``sums`` over ``count`` elements a group, in fp32, rounded to
    x's dtype once."""
    a, b = _coeffs(*_fold(sums, num_groups, count, eps), gain, shift)
    y = x.to(torch.float32) * a[:, None, None, :] + b[:, None, None, :]
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def fused_group_norm_silu_plain(x, gain, shift, num_groups: int, eps: float, apply_silu: bool = True):
    """silu((x - mean_g) * rstd_g * gain + shift) in fp32, rounded to x's
    dtype once."""
    a, b = gn_coeffs_plain(x, num_groups, eps, gain, shift)
    y = x.to(torch.float32) * a[:, None, None, :] + b[:, None, None, :]
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


# ----------------------------------------------------------------- kernel
def _check(x, num_groups, gain, shift, affine: bool = True):
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
    for name, t in (("gain", gain), ("shift", shift)) if affine else ():
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


def _launch(x, gain, shift, num_groups: int, eps: float, apply_silu: bool):
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


def gn_stats(x):
    """(2, B, C) fp32 sums of x and x^2 over x's pixels: the kernel's stats
    launch on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return gn_stats_plain(x)
    _check(x, 1, None, None, affine=False)
    lib = _lib()
    B, H, W, C = x.shape
    la = _launch_args(B, H, W, C)
    sums = torch.empty((2, B, C), dtype=torch.float32, device=x.device)
    rc = lib.gn_stats_launch(x.data_ptr(), sums.data_ptr(), B, H * W, C, la.cluster, la.rows_per_cta,
                             la.threads_per_row, la.rows_per_pass, la.smem_bytes, build.stream_ptr(x.device))
    build.check(lib, rc, "gn_stats")
    gn_stats.launches += 1
    return sums


def gn_apply(x, sums, count, gain, shift, num_groups: int, eps: float, apply_silu: bool = True):
    """[silu](GN(x) * gain + shift) from the (2, B, C) ``sums`` over
    ``count`` elements a group: the kernel's apply launch on a CUDA tensor,
    the plain version on a CPU one."""
    if x.device.type == "cpu":
        return gn_apply_plain(x, sums, count, gain, shift, num_groups, eps, apply_silu)
    _check(x, num_groups, gain, shift)
    B, H, W, C = x.shape
    if sums.dtype != torch.float32 or tuple(sums.shape) != (2, B, C) or not sums.is_contiguous() \
            or sums.device != x.device:
        raise ValueError(f"gn_apply: sums must be contiguous fp32 (2, {B}, {C}) on {x.device}")
    lib = _lib()
    gain, shift, gstride = _affine_args(x, gain, shift)
    la = _launch_args(B, H, W, C)
    y = torch.empty_like(x)
    rc = lib.gn_apply_launch(
        x.data_ptr(), y.data_ptr(), sums.data_ptr(), gain.data_ptr(), shift.data_ptr(), gstride,
        B, H * W, C, num_groups, la.cluster, la.rows_per_cta, la.threads_per_row, la.rows_per_pass,
        float(count), float(eps), int(apply_silu), build.stream_ptr(x.device),
    )
    build.check(lib, rc, "gn_apply")
    gn_apply.launches += 1
    return y


def _sharded_forward(x, gain, shift, num_groups: int, eps: float, apply_silu: bool, width):
    """(y, the summed (2, B, C) sums, the count a group)."""
    B, H, W, C = x.shape
    sums = all_reduce_sum_(gn_stats(x), width)
    count = H * W * width.width_size * (C // num_groups)
    return gn_apply(x, sums, count, gain, shift, num_groups, eps, apply_silu), sums, count


class GroupNormSiLUSharded(torch.autograd.Function):
    """``group_norm_silu_sharded`` under autograd (the module docstring)."""

    @staticmethod
    def forward(ctx, x, gain, shift, num_groups: int, eps: float, apply_silu: bool, width):
        y, sums, count = _sharded_forward(x, gain, shift, num_groups, eps, apply_silu, width)
        ctx.save_for_backward(x, gain, shift, sums)
        ctx.args = (num_groups, eps, apply_silu, count, width)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gain, shift, sums = ctx.saved_tensors
        num_groups, eps, apply_silu, count, width = ctx.args
        mean, rstd = _fold(sums, num_groups, count, eps)
        dx, d_gain, d_shift = _backward(x, gain, shift, num_groups, apply_silu, dy, mean, rstd, count, width)
        return dx, d_gain, d_shift, None, None, None, None


def group_norm_silu_sharded(x, gain, shift, num_groups: int, eps: float, apply_silu: bool, width):
    """The split form under a width axis: ``gn_stats``, the sums all-reduced
    over ``width``'s group, ``gn_apply`` with the whole image's count; under
    autograd ``GroupNormSiLUSharded``."""
    if torch.is_grad_enabled() and (x.requires_grad or gain.requires_grad or shift.requires_grad):
        return GroupNormSiLUSharded.apply(x, gain, shift, num_groups, eps, apply_silu, width)
    return _sharded_forward(x, gain, shift, num_groups, eps, apply_silu, width)[0]


# ----------------------------------------------------------------- backward
def gn_silu_backward(x, gain, shift, num_groups: int, eps: float, apply_silu: bool, dy):
    """(dx, d_gain, d_shift) of ``fused_group_norm_silu`` at (x, gain, shift)
    for the output gradient dy, in fp32 PyTorch ops. The group statistics
    are recomputed as ``gn_coeffs_plain`` sums them; with z = x*a + b the
    folded affine, dz = dy * silu'(z); then, per (sample, channel), with
    xhat = (x - mean) * rstd:

        d_shift = sum dz,  d_gain = sum dz * xhat = rstd * (sum dz*x - mean * d_shift)
        dx = rstd * (g*dz - m1 - xhat * m2),  m1, m2 the group means of g*dz and g*dz*xhat,

    written as dx = A*dz + Bx*x + Cc with (B, C) coefficients, so that the
    activation-sized work is a few passes. d_gain and d_shift have their
    operand's shape: summed over the batch for a (C,) vector, per sample for
    a (B, C) AdaGN gain. dx has x's dtype, d_gain and d_shift their
    operand's."""
    B, H, W, C = x.shape
    mean, rstd = _group_stats(x.to(torch.float32).reshape(B, H * W, C), num_groups, eps)
    return _backward(x, gain, shift, num_groups, apply_silu, dy, mean, rstd, H * W * (C // num_groups))


def _backward(x, gain, shift, num_groups: int, apply_silu: bool, dy, mean, rstd, cnt, width=None):
    """``gn_silu_backward`` from the (B, C) group ``mean`` and ``rstd`` over
    ``cnt`` elements a group; under a width axis (``width``) the sums of dz
    and dz*x that dx needs are the whole image's, all-reduced over the
    group, and d_gain, d_shift this rank's share."""
    B, H, W, C = x.shape
    G = num_groups
    xf = x.to(torch.float32).reshape(B, H * W, C)
    g, s = _affine(gain, shift, B, C)
    a = rstd * g
    if apply_silu:
        z = torch.addcmul((s - mean * a)[:, None], xf, a[:, None])
        sig = torch.sigmoid(z)
        # silu'(z) = sig * (1 + z * (1 - sig)), times dy, in place
        dz = torch.sub(1.0, sig).mul_(z).add_(1.0).mul_(sig).mul_(dy.reshape(B, H * W, C))
        del z, sig
    else:
        dz = dy.to(torch.float32).reshape(B, H * W, C)
    own = torch.stack([dz.sum(dim=1), (dz * xf).sum(dim=1)])  # (2, B, C): sums of dz, dz*x
    total = own if width is None else all_reduce_sum_(own.clone(), width)
    d_shift = own[0]
    d_gain = rstd * (own[1] - mean * d_shift)

    def group_mean(v):
        return (v.reshape(B, G, -1).sum(-1) / cnt).repeat_interleave(C // G, dim=1)

    m1, m2 = group_mean(g * total[0]), group_mean(g * (rstd * (total[1] - mean * total[0])))
    coef_x = -rstd * rstd * m2
    dx = torch.addcmul((-rstd * m1 - coef_x * mean)[:, None], dz, a[:, None])
    dx.addcmul_(xf, coef_x[:, None])

    def to_operand(d, t):
        return (d.sum(0) if t.dim() == 1 else d).to(t.dtype)

    return dx.reshape(B, H, W, C).to(x.dtype), to_operand(d_gain, gain), to_operand(d_shift, shift)


class GroupNormSiLU(torch.autograd.Function):
    """``fused_group_norm_silu`` under autograd: the forward is the kernel on
    a CUDA tensor (the plain version on a CPU one, which the CPU tests use to
    reach the backward), the backward ``gn_silu_backward``."""

    @staticmethod
    def forward(ctx, x, gain, shift, num_groups: int, eps: float, apply_silu: bool):
        ctx.save_for_backward(x, gain, shift)
        ctx.args = (num_groups, eps, apply_silu)
        if x.device.type == "cpu":
            return fused_group_norm_silu_plain(x, gain, shift, num_groups, eps, apply_silu)
        return _launch(x, gain, shift, num_groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, dy):
        x, gain, shift = ctx.saved_tensors
        dx, d_gain, d_shift = gn_silu_backward(x, gain, shift, *ctx.args, dy)
        return dx, d_gain, d_shift, None, None, None


def fused_group_norm_silu(x, gain, shift, num_groups: int, eps: float, apply_silu: bool = True):
    """[silu](GN(x) * gain + shift) on NHWC x; gain/shift (C,) or (B, C)."""
    if x.device.type == "cpu":
        return fused_group_norm_silu_plain(x, gain, shift, num_groups, eps, apply_silu)
    if torch.is_grad_enabled() and (x.requires_grad or gain.requires_grad or shift.requires_grad):
        return GroupNormSiLU.apply(x, gain, shift, num_groups, eps, apply_silu)
    return _launch(x, gain, shift, num_groups, eps, apply_silu)


fused_group_norm_silu.launches = 0
gn_stats.launches = 0
gn_apply.launches = 0
