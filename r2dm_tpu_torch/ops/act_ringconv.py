"""Fused (affine + SiLU) prologue + 3x3 ring convolution, NHWC: the CUDA
kernel ``csrc/act_ringconv.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``r2dm_tpu/ops/pallas_resconv.py::fused_act_ringconv``
with the same signature and layouts:

    y = ring_conv3x3(silu(x * a + b), kernel) + bias     # apply_act=True
    y = ring_conv3x3(x, kernel) + bias                    # apply_act=False

x (B, H, W, C) NHWC; a, b (B, C) fp32; kernel (3, 3, C, F) HWIO; bias (F,).
W wraps circularly; H is zero-padded AFTER the activation. A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.
``fused_act_ringconv.launches`` counts kernel launches.

Under a width axis, ``halo=(left, right)`` gives the two (B, H, 1, C)
columns that close the ring on this rank's W columns (the left neighbour's
last, the right neighbour's first: ``parallel/width.py::halo_exchange``):
``act_ringconv_halo``, the kernel's halo'd form, reads them in place of the
wrap and writes W columns. Its launches count in ``act_ringconv_halo
.launches``, apart from the ring form's.

``act_ringconv_sharded(x, kernel, bias, width)`` is the exchange and the
halo'd conv in one call, and under autograd the ``ActRingConvHalo``
function. Its backward is the one-rank backward with the ring closed across
ranks: the adjoint of "close the ring with the neighbours' columns, then 3x3
conv" is the same halo'd conv of dy, closed with dy's own exchanged strips,
so dx is one launch of the halo'd kernel (counted in ``act_ringconv_halo
.launches``) and is the whole gradient of this rank's columns, the terms of
the neighbours' outputs included. The forward's x strips are therefore not
differentiated (the exchange runs inside the forward, off the graph): the
neighbours count those terms. dW and d_bias are this rank's columns' share,
``ring_conv_weight_grad`` on the strip-padded x; the trainer sums the shares
over the width group.

Under autograd the call is the ``ActRingConv`` function (``apply_act=False``
only, the form every path uses; with the prologue it raises). The adjoint of
"zero-pad H, wrap W, 3x3 conv" is the same ring conv of dy with the kernel
flipped in (kh, kw) and its channels swapped, so dx is one more launch of
this kernel (``ring_conv_input_grad``, counted in ``.launches``). dW, the
correlation of the ring-padded x with dy, and d_bias are PyTorch ops, as the
JAX package leaves both to XLA (``ring_conv_weight_grad``); a dW kernel is a
later optimisation (ROADMAP).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..parallel.width import halo_exchange
from . import build
from .pad import ring_pad

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_HALO_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _lib():
    lib = build.load("act_ringconv")
    if lib.act_ringconv_launch.argtypes is None:
        lib.act_ringconv_launch.argtypes = _ARGS
        lib.act_ringconv_launch.restype = ctypes.c_int
        lib.act_ringconv_halo_launch.argtypes = _HALO_ARGS
        lib.act_ringconv_halo_launch.restype = ctypes.c_int
    return lib


def act_ringconv_plain(x, a, b, kernel, bias, apply_act: bool = True, halo=None):
    """silu(x*a + b) in fp32 rounded to x's dtype -> zero pad on H ->
    circular pad on W (or, with ``halo``, the two halo columns activated
    the same way) -> conv2d + bias, in x's dtype."""

    def act(t):
        if not apply_act:
            return t
        s = t.to(torch.float32) * a[:, None, None, :] + b[:, None, None, :]
        return (s * torch.sigmoid(s)).to(x.dtype)

    if halo is None:
        s = ring_pad(act(x), 1)
    else:
        s = ring_pad(torch.cat([act(halo[0]), act(x), act(halo[1])], dim=2), (0, 0, 1, 1))
    weight = kernel.to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(s.permute(0, 3, 1, 2), weight, bias.to(x.dtype))
    return y.permute(0, 2, 3, 1).contiguous()


def pack_weight(kernel, dtype=torch.bfloat16):
    """HWIO (3, 3, C, F) -> (F, 9*C) in ``dtype``, column (kh*3 + kw)*C + c:
    each output channel's taps with the input channels innermost, so one
    16-byte copy reads 8 input channels of one output channel (the kernel's
    K-major operand). One pass: the cast and the permute are one copy."""
    packed = torch.empty(kernel.shape[3], *kernel.shape[:3], dtype=dtype, device=kernel.device)
    packed.copy_(kernel.permute(3, 0, 1, 2))
    return packed.view(kernel.shape[3], -1)


def _check(x, a, b, kernel, bias, apply_act, halo=None):
    if not x.is_cuda:
        raise ValueError(f"act_ringconv: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"act_ringconv: the CUDA kernel takes bfloat16 activations, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"act_ringconv: expected a contiguous NHWC tensor, got shape {tuple(x.shape)}")
    B, H, W, C = x.shape
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, C):
        raise ValueError(f"act_ringconv: kernel shape {tuple(kernel.shape)} is not (3, 3, {C}, F)")
    Fo = kernel.shape[3]
    if C % 8 or Fo % 8:
        raise ValueError(f"act_ringconv: C={C} and F={Fo} must be multiples of 8")
    if tuple(bias.shape) != (Fo,):
        raise ValueError(f"act_ringconv: bias shape {tuple(bias.shape)} is not ({Fo},)")
    tensors = [kernel, bias]
    if apply_act:
        for name, t in (("a", a), ("b", b)):
            if t.dtype != torch.float32 or tuple(t.shape) != (B, C) or not t.is_contiguous():
                raise ValueError(f"act_ringconv: {name} must be contiguous fp32 ({B}, {C})")
        tensors += [a, b]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"act_ringconv: operands on {t.device} and {x.device}")
    strips = []
    if halo is not None:
        for name, t in zip(("left", "right"), halo):
            if (t.dtype != x.dtype or tuple(t.shape) != (B, H, 1, C) or not t.is_contiguous()
                    or t.device != x.device):
                raise ValueError(f"act_ringconv: the {name} halo must be a contiguous {x.dtype} "
                                 f"({B}, {H}, 1, {C}) tensor on {x.device}")
            strips.append(t)
    for t in [x] + tensors[2:] + strips:  # 16-byte vector loads of x, a, b and the halo strips
        if t.data_ptr() % 16:
            raise ValueError("act_ringconv: x, a, b and the halo strips must start on a 16-byte boundary")


def _launch(x, a, b, kernel, bias, apply_act: bool, halo=None):
    _check(x, a, b, kernel, bias, apply_act, halo)
    lib = _lib()
    B, H, W, C = x.shape
    Fo = kernel.shape[3]
    w = pack_weight(kernel)
    bias32 = bias.to(torch.float32).contiguous()
    y = torch.empty((B, H, W, Fo), dtype=torch.bfloat16, device=x.device)
    pa = a.data_ptr() if apply_act else None
    pb = b.data_ptr() if apply_act else None
    tail = (w.data_ptr(), bias32.data_ptr(), y.data_ptr(), B, H, W, C, Fo, int(apply_act),
            build.stream_ptr(x.device))
    if halo is None:
        rc = lib.act_ringconv_launch(x.data_ptr(), pa, pb, *tail)
        build.check(lib, rc, "fused_act_ringconv")
        fused_act_ringconv.launches += 1
    else:
        rc = lib.act_ringconv_halo_launch(x.data_ptr(), halo[0].data_ptr(), halo[1].data_ptr(), pa, pb, *tail)
        build.check(lib, rc, "act_ringconv_halo")
        act_ringconv_halo.launches += 1
    return y


# ----------------------------------------------------------------- backward
def ring_conv_input_grad(dy, kernel):
    """dx of y = ring_conv3x3(x, kernel) + bias: the ring conv of dy with
    W'[kh, kw, f, c] = W[2-kh, 2-kw, c, f] and zero bias, through
    ``fused_act_ringconv`` (the kernel on a CUDA tensor)."""
    flipped = kernel.flip(0, 1).transpose(2, 3)
    zeros = torch.zeros(kernel.shape[2], dtype=torch.float32, device=dy.device)
    return fused_act_ringconv(dy.contiguous(), None, None, flipped, zeros, apply_act=False)


def ring_conv_weight_grad(x, dy, kernel_dtype, bias_dtype, halo=None):
    """(dW HWIO, d_bias) of y = ring_conv3x3(x, W) + bias, in x's dtype with
    fp32 accumulation, returned in the parameters' dtypes: dW is the
    correlation of the ring-padded x with dy (torch.nn.grad.conv2d_weight),
    d_bias the sum of dy over (B, H, W). With ``halo=(left, right)`` the
    ring is closed by those columns (a rank's share under a width axis)."""
    if halo is None:
        xp = ring_pad(x, 1).permute(0, 3, 1, 2)
    else:
        xp = ring_pad(torch.cat([halo[0], x, halo[1]], dim=2), (0, 0, 1, 1)).permute(0, 3, 1, 2)
    Fo = dy.shape[-1]
    dw = torch.nn.grad.conv2d_weight(xp, (Fo, x.shape[-1], 3, 3), dy.to(x.dtype).permute(0, 3, 1, 2))
    d_bias = dy.to(torch.float32).sum(dim=(0, 1, 2))
    return dw.permute(2, 3, 1, 0).to(kernel_dtype), d_bias.to(bias_dtype)


class ActRingConv(torch.autograd.Function):
    """``fused_act_ringconv(apply_act=False)`` under autograd: the forward is
    the kernel on a CUDA tensor (the plain version on a CPU one, which the
    CPU tests use to reach the backward); dx goes through the kernel again,
    dW and d_bias through ``ring_conv_weight_grad``."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        ctx.bias_dtype = bias.dtype
        if x.device.type == "cpu":
            return act_ringconv_plain(x, None, None, kernel, bias, apply_act=False)
        return _launch(x, None, None, kernel, bias, apply_act=False)

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        dx = ring_conv_input_grad(dy.to(x.dtype), kernel) if ctx.needs_input_grad[0] else None
        dw, d_bias = ring_conv_weight_grad(x, dy, kernel.dtype, ctx.bias_dtype)
        return dx, dw, d_bias


def act_ringconv_halo(x, left, right, a, b, kernel, bias, apply_act: bool = True):
    """The halo'd form: y = conv3x3([silu](x*a + b)) + bias over this rank's
    W columns, the ring closed by the (B, H, 1, C) ``left`` and ``right``
    columns; NHWC, x's dtype. Under autograd use ``act_ringconv_sharded``
    (a call here with an operand that takes a gradient raises on CUDA)."""
    halo = (left, right)
    if x.device.type == "cpu":
        return act_ringconv_plain(x, a, b, kernel, bias, apply_act, halo=halo)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, left, right, a, b, kernel, bias)):
        raise NotImplementedError("act_ringconv_halo: no backward of its own; under autograd call "
                                  "act_ringconv_sharded, whose backward closes the ring across ranks")
    return _launch(x, a, b, kernel, bias, apply_act, halo=halo)


class ActRingConvHalo(torch.autograd.Function):
    """``act_ringconv_sharded`` under autograd (the module docstring): the
    forward exchanges x's edge columns and runs the halo'd kernel (the plain
    version on a CPU tensor); the backward exchanges dy's, and dx is the
    halo'd kernel on dy with the flipped, channel-swapped kernel; dW and
    d_bias this rank's share."""

    @staticmethod
    def forward(ctx, x, kernel, bias, width):
        left, right = halo_exchange(x, 1, 1, width)
        ctx.save_for_backward(x, left, right, kernel)
        ctx.bias_dtype, ctx.width = bias.dtype, width
        return act_ringconv_halo(x, left, right, None, None, kernel, bias, apply_act=False)

    @staticmethod
    def backward(ctx, dy):
        x, left, right, kernel = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            flipped = kernel.flip(0, 1).transpose(2, 3)
            zeros = torch.zeros(kernel.shape[2], dtype=torch.float32, device=dy.device)
            dx = act_ringconv_halo(dy, *halo_exchange(dy, 1, 1, ctx.width), None, None, flipped, zeros,
                                   apply_act=False)
        dw, d_bias = ring_conv_weight_grad(x, dy, kernel.dtype, ctx.bias_dtype, halo=(left, right))
        return dx, dw, d_bias, None


def act_ringconv_sharded(x, kernel, bias, width):
    """y = ring_conv3x3(x, kernel) + bias on this rank's columns of a width
    axis (``width``, a ``World``): the edge columns exchanged, then the
    halo'd form; under autograd ``ActRingConvHalo``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernel, bias)):
        return ActRingConvHalo.apply(x, kernel, bias, width)
    return act_ringconv_halo(x, *halo_exchange(x, 1, 1, width), None, None, kernel, bias, apply_act=False)


def fused_act_ringconv(x, a, b, kernel, bias, apply_act: bool = True, halo=None):
    """y = ring_conv3x3([silu](x*a + b), kernel) + bias, NHWC, x's dtype;
    with ``halo=(left, right)``, ``act_ringconv_halo``."""
    if halo is not None:
        return act_ringconv_halo(x, *halo, a, b, kernel, bias, apply_act)
    if x.device.type == "cpu":
        return act_ringconv_plain(x, a, b, kernel, bias, apply_act)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, a, b, kernel, bias)):
        if apply_act:
            raise NotImplementedError(
                "fused_act_ringconv: no backward with the SiLU prologue (apply_act=True); "
                "under autograd apply the activation first and call it with apply_act=False"
            )
        return ActRingConv.apply(x, kernel, bias)
    return _launch(x, a, b, kernel, bias, apply_act)


fused_act_ringconv.launches = 0
act_ringconv_halo.launches = 0
