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
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .pad import ring_pad

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _lib():
    lib = build.load("act_ringconv")
    if lib.act_ringconv_launch.argtypes is None:
        lib.act_ringconv_launch.argtypes = _ARGS
        lib.act_ringconv_launch.restype = ctypes.c_int
    return lib


def act_ringconv_plain(x, a, b, kernel, bias, apply_act: bool = True):
    """silu(x*a + b) in fp32 rounded to x's dtype -> zero pad on H ->
    circular pad on W -> conv2d + bias, in x's dtype."""
    if apply_act:
        s = x.to(torch.float32) * a[:, None, None, :] + b[:, None, None, :]
        s = (s * torch.sigmoid(s)).to(x.dtype)
    else:
        s = x
    s = ring_pad(s, 1)
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


def _check(x, a, b, kernel, bias, apply_act):
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
    for t in [x] + tensors[2:]:  # 16-byte vector loads of x, a and b
        if t.data_ptr() % 16:
            raise ValueError("act_ringconv: x, a and b must start on a 16-byte boundary")


def fused_act_ringconv(x, a, b, kernel, bias, apply_act: bool = True):
    """y = ring_conv3x3([silu](x*a + b), kernel) + bias, NHWC, x's dtype."""
    if x.device.type == "cpu":
        return act_ringconv_plain(x, a, b, kernel, bias, apply_act)
    _check(x, a, b, kernel, bias, apply_act)
    lib = _lib()
    B, H, W, C = x.shape
    Fo = kernel.shape[3]
    w = pack_weight(kernel)
    bias32 = bias.to(torch.float32).contiguous()
    y = torch.empty((B, H, W, Fo), dtype=torch.bfloat16, device=x.device)
    pa = a.data_ptr() if apply_act else None
    pb = b.data_ptr() if apply_act else None
    rc = lib.act_ringconv_launch(
        x.data_ptr(), pa, pb, w.data_ptr(), bias32.data_ptr(), y.data_ptr(),
        B, H, W, C, Fo, int(apply_act), build.stream_ptr(x.device),
    )
    build.check(lib, rc, "fused_act_ringconv")
    fused_act_ringconv.launches += 1
    return y


fused_act_ringconv.launches = 0
