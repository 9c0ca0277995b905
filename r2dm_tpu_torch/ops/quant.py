"""The W8A8 int8 serving lane: a 3x3 ring convolution on s8 x s8 -> s32,
NHWC. The CUDA kernels ``csrc/w8a8_ringconv.cu`` and their plain PyTorch
versions.

Replaces ``r2dm_tpu/ops/quant.py::ring_conv_w8a8``, an XLA int8 convolution
(not a Pallas kernel), with the same arithmetic:

  * weights: symmetric per-output-channel s8 of the fp32 master kernel,
    scale = absmax / 127 + 1e-12 (``weight_qparams``);
  * activations: symmetric per-tensor s8 with a dynamic scale, the absmax
    taken in fp32 over the whole tensor (``act_qparams``), so a sample's
    values depend on the rest of its batch; a NaN anywhere makes the scale
    NaN and so every output NaN;
  * q = clip(round_half_even(v / scale), -127, 127), a true division;
  * y = float(conv(ring_pad(xq), kq)) * (x_scale * w_scale[f]) + bias[f],
    cast to ``out_dtype``; the s32 sum is exact (|sum| <= 9 C 127^2 < 2^31
    for C_in up to 14,793).

A CPU tensor takes the plain version (the integer conv in float64, which is
exact); a CUDA tensor launches three kernels or raises, each counting its
launches in ``.launches``: ``act_absmax`` (the activation's absmax, one fp32
value on the card), ``act_quantize`` (x quantized once into the conv's
layout: s8 (B, H, W + 2, Cp), the W ring's columns written in, the channels
zero-padded to Cp) and the s8 conv on that operand, ``ring_conv_s8``,
counted in ``ring_conv_w8a8.launches``. The lane is inference-only, as in
the JAX package (round has no gradient): under autograd it raises.

Under a width axis (``width``, a ``World`` whose width group splits the
columns) the lane computes on a rank's columns what one rank computes on
the whole image, as the JAX package's ``jnp.max`` over a width-sharded
tensor is a global max: the absmax is the maximum over the width group,
reduced on the bits of |x| as int32 (``parallel.all_reduce_max_bits_``,
the kernel's own encoding, so a NaN in one rank's columns makes every
rank's scale NaN); the quantize pass's halo'd form, ``act_quantize(halo=)``
(the kernel's ``kHalo`` form, launches counted in ``act_quantize_halo
.launches``), writes the ring's two columns from x's exchanged edge columns
with that scale; the s8 conv is unchanged. Each rank's s8 layout is then its
window of one rank's, and its output its columns of one rank's, bit for bit.

On CUDA, PyTorch computes ``tensor / python_float`` as a multiplication by
the reciprocal, which rounds otherwise than the JAX package's division, so
every division here takes a tensor divisor.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.width import all_reduce_max_bits_, halo_exchange, sharded
from . import build
from .pad import ring_pad

EPS = 1e-12
QMAX = 127
K_CHUNK = 64  # input channels per K slice of the s8 conv; xq and the packed weight pad C_in to it
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def _lib():
    lib = build.load("w8a8_ringconv")
    if lib.w8a8_ringconv_launch.argtypes is None:
        lib.w8a8_ringconv_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.w8a8_ringconv_launch.restype = ctypes.c_int
        lib.quantize_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.quantize_launch.restype = ctypes.c_int
        lib.quantize_halo_launch.argtypes = [ctypes.c_void_p] * 3 + list(lib.quantize_launch.argtypes[1:])
        lib.quantize_halo_launch.restype = ctypes.c_int
        lib.absmax_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                                      ctypes.c_void_p]
        lib.absmax_launch.restype = ctypes.c_int
    return lib


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """absmax / 127 + 1e-12 in fp32, a true division (quant.py:53,62)."""
    return absmax / torch.full((), float(QMAX), device=absmax.device) + EPS


def _quantize(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v / scale), -QMAX, QMAX).to(torch.int8)


def weight_qparams(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """HWIO kernel -> (s8 kernel, fp32 scale (F,)) with kernel ~= kq * scale
    (quant.py:46-56)."""
    k = kernel.to(torch.float32)
    scale = _scale(k.abs().amax(dim=(0, 1, 2)))
    return _quantize(k, scale), scale


def act_qparams(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor s8 of an activation: (xq, fp32 scale ()) (quant.py:
    59-64)."""
    xf = x.to(torch.float32)
    scale = _scale(xf.abs().amax())
    return _quantize(xf, scale), scale


def conv_s8(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """The integer part, exactly: conv(ring_pad(xq), kq) as int32 (B, H, W,
    F), W wrapped and H zero-padded, summed in float64 (every partial sum is
    an integer below 2^53)."""
    xp = ring_pad(xq.to(torch.float64), 1).permute(0, 3, 1, 2)
    y = F.conv2d(xp, kq.to(torch.float64).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).round().to(torch.int32).contiguous()


def ring_conv_w8a8_plain(x, kernel, bias, out_dtype=None) -> torch.Tensor:
    """The plain version: quantize, the exact integer conv, then
    float(y) * (x_scale * w_scale) + bias, cast to ``out_dtype`` (x's
    dtype when None) in the order of quant.py:104-107."""
    out_dtype = out_dtype or x.dtype
    xq, xs = act_qparams(x)
    kq, ks = weight_qparams(kernel)
    out = conv_s8(xq, kq).to(torch.float32) * (xs * ks)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(out_dtype)


def padded_channels(c: int) -> int:
    """Cp: C_in rounded up to a multiple of K_CHUNK, the channels of xq and
    of the packed weight."""
    return -(-c // K_CHUNK) * K_CHUNK


def act_quantize_plain(x: torch.Tensor, amax: torch.Tensor, halo=None) -> torch.Tensor:
    """The quantize pass's plain version: x (B, H, W, C) -> s8 (B, H, W + 2,
    Cp), the values of ``act_qparams`` for the absmax ``amax``, ring-padded
    by one column each side (with ``halo``, the (B, H, 1, C) columns
    ``(left, right)``, quantized alike) and zero-padded to Cp channels."""
    scale = _scale(amax.to(torch.float32))
    if halo is None:
        xq = ring_pad(_quantize(x.to(torch.float32), scale), (1, 1, 0, 0))
    else:
        xq = _quantize(torch.cat([halo[0], x, halo[1]], dim=2).to(torch.float32), scale)
    return F.pad(xq, (0, padded_channels(x.shape[3]) - x.shape[3]))


def conv_s8_padded(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The s8 conv's integer part on its own operands, exactly: xq (B, H,
    W + 2, Cp) from the quantize pass and wq (F, 9, Cp) from ``pack_weight``
    -> int32 (B, H, W, F), H zero-padded, summed in float64."""
    Fo, _, cp = wq.shape
    xp = F.pad(xq.to(torch.float64).permute(0, 3, 1, 2), (0, 0, 1, 1))
    y = F.conv2d(xp, wq.to(torch.float64).view(Fo, 3, 3, cp).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).round().to(torch.int32).contiguous()


def ring_conv_s8_plain(xq, amax, packed, bias, out_dtype) -> torch.Tensor:
    """The s8 conv's plain version: ``conv_s8_padded``, then float(y) *
    (x_scale * w_scale) + bias, cast to ``out_dtype`` (int32: the sums)."""
    wq, ks = packed
    acc = conv_s8_padded(xq, wq)
    if out_dtype == torch.int32:
        return acc
    out = acc.to(torch.float32) * (_scale(amax.to(torch.float32)) * ks)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(out_dtype)


def pack_weight(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """HWIO fp32 kernel -> (s8 (F, 9, Cp) with column (kh*3 + kw, c), C_in
    zero-padded to Cp (``padded_channels``); fp32 scales (F,)): the conv's
    K-major B operand."""
    kq, ks = weight_qparams(kernel)
    C, Fo = kq.shape[2], kq.shape[3]
    cp = padded_channels(C)
    packed = torch.zeros((Fo, 9, cp), dtype=torch.int8, device=kernel.device)
    packed[:, :, :C] = kq.permute(3, 0, 1, 2).reshape(Fo, 9, C)
    return packed, ks.contiguous()


def _check(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: the CUDA kernels take float32 or bfloat16 activations, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: expected a contiguous tensor on a 16-byte boundary")


def act_absmax(x: torch.Tensor, width=None) -> torch.Tensor:
    """max |x| over the whole tensor, as a 0-d fp32 tensor (NaN when x holds
    one): the reduction kernel on a CUDA tensor (every block folds its
    maximum in with an integer atomicMax on the bits of |x|, a NaN as the
    quiet NaN above +inf; exact and independent of the order; the output
    zero-filled here first), ``x.abs().amax()`` on a CPU one. Under a width
    axis (``width``) the maximum over the group's columns, on the same
    bits."""
    if sharded(width):
        return all_reduce_max_bits_(act_absmax(x), width)
    if x.device.type == "cpu":
        return x.to(torch.float32).abs().amax()
    _check(x, "act_absmax")
    lib = _lib()
    out = torch.zeros((), dtype=torch.float32, device=x.device)
    rc = lib.absmax_launch(x.data_ptr(), _DTYPE_CODE[x.dtype], x.numel(), out.data_ptr(),
                           build.stream_ptr(x.device))
    build.check(lib, rc, "act_absmax")
    act_absmax.launches += 1
    return out


def _check_amax(amax: torch.Tensor, x: torch.Tensor, what: str) -> None:
    if amax.dtype != torch.float32 or amax.numel() != 1 or amax.device != x.device:
        raise ValueError(f"{what}: amax must be one fp32 value on x's device")


def act_quantize(x: torch.Tensor, amax: torch.Tensor, halo=None) -> torch.Tensor:
    """x (B, H, W, C) fp32 or bf16 quantized once for the s8 conv: s8 (B, H,
    W + 2, Cp), column 0 x's column W - 1 and column W + 1 its column 0 (the
    ring), channels past C zero, each value clip(round_half_even(x / xs),
    -127, 127) with xs from ``amax`` (x's ``act_absmax``). With
    ``halo=(left, right)``, ``act_quantize_halo``. The quantize kernel on a
    CUDA tensor, ``act_quantize_plain`` on a CPU one."""
    if halo is not None:
        return act_quantize_halo(x, *halo, amax)
    if x.dim() != 4:
        raise ValueError(f"act_quantize: expected NHWC x, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return act_quantize_plain(x, amax)
    return _quantize_launch(x, amax)


def act_quantize_halo(x: torch.Tensor, left: torch.Tensor, right: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """The quantize pass's halo'd form under a width axis: columns 0 and
    W + 1 of the s8 layout from the (B, H, 1, C) ``left`` and ``right``
    columns (the neighbours' edge columns, in x's dtype) in place of the
    wrap, with the same scale; the kernel's ``kHalo`` form on CUDA tensors
    (launches counted here), ``act_quantize_plain(halo=)`` on CPU ones."""
    if x.dim() != 4:
        raise ValueError(f"act_quantize: expected NHWC x, got shape {tuple(x.shape)}")
    B, H, _, C = x.shape
    for name, t in (("left", left), ("right", right)):
        if t.dtype != x.dtype or tuple(t.shape) != (B, H, 1, C) or t.device != x.device:
            raise ValueError(f"act_quantize_halo: the {name} halo must be a {x.dtype} ({B}, {H}, 1, {C}) tensor "
                             f"on {x.device}")
    if x.device.type == "cpu":
        return act_quantize_plain(x, amax, halo=(left, right))
    for t in (left, right):
        _check(t, "act_quantize_halo")
    return _quantize_launch(x, amax, (left, right))


def _quantize_launch(x, amax, halo=None):
    what = "act_quantize" if halo is None else "act_quantize_halo"
    _check(x, what)
    _check_amax(amax, x, what)
    B, H, W, C = x.shape
    cp = padded_channels(C)
    lib = _lib()
    xq = torch.empty((B, H, W + 2, cp), dtype=torch.int8, device=x.device)
    tail = (_DTYPE_CODE[x.dtype], amax.data_ptr(), xq.data_ptr(), B * H, W, C, cp, build.stream_ptr(x.device))
    if halo is None:
        rc = lib.quantize_launch(x.data_ptr(), *tail)
        build.check(lib, rc, what)
        act_quantize.launches += 1
    else:
        rc = lib.quantize_halo_launch(x.data_ptr(), halo[0].data_ptr(), halo[1].data_ptr(), *tail)
        build.check(lib, rc, what)
        act_quantize_halo.launches += 1
    return xq


def ring_conv_s8(xq: torch.Tensor, amax: torch.Tensor, packed, bias, out_dtype: torch.dtype) -> torch.Tensor:
    """The s8 conv alone, on the quantize pass's output xq (B, H, W + 2, Cp)
    and ``pack_weight``'s (wq, ks): (B, H, W, F) in ``out_dtype`` (float32,
    bfloat16, or int32 for the raw sums). The kernel on CUDA tensors (its
    launches counted in ``ring_conv_w8a8.launches``), ``ring_conv_s8_plain``
    on CPU ones."""
    wq, ks = packed
    if xq.dim() != 4 or xq.dtype != torch.int8 or wq.dim() != 3 or tuple(wq.shape[1:]) != (9, xq.shape[3]) \
            or xq.shape[3] % K_CHUNK or tuple(ks.shape) != (wq.shape[0],):
        raise ValueError(f"ring_conv_s8: xq {tuple(xq.shape)} {xq.dtype} and packed weight {tuple(wq.shape)} "
                         "are not the quantize pass's and pack_weight's")
    Fo = wq.shape[0]
    if bias is not None:
        if tuple(bias.shape) != (Fo,):
            raise ValueError(f"ring_conv_s8: bias shape {tuple(bias.shape)} is not ({Fo},)")
        bias = bias.to(torch.float32).contiguous()
    if xq.device.type == "cpu":
        return ring_conv_s8_plain(xq, amax, packed, bias, out_dtype)
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"ring_conv_s8: no output in {out_dtype}")
    for t in (xq, wq, ks) + ((bias,) if bias is not None else ()):
        if t.device != xq.device or not t.is_contiguous():
            raise ValueError(f"ring_conv_s8: operands on {t.device} and {xq.device}, or not contiguous")
    _check_amax(amax, xq, "ring_conv_s8")
    B, H, Wp, cp = xq.shape
    lib = _lib()
    y = torch.empty((B, H, Wp - 2, Fo), dtype=out_dtype, device=xq.device)
    rc = lib.w8a8_ringconv_launch(
        xq.data_ptr(), amax.data_ptr(), wq.data_ptr(), ks.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(), _DTYPE_CODE[out_dtype],
        B, H, Wp - 2, cp, Fo, build.stream_ptr(xq.device),
    )
    build.check(lib, rc, "ring_conv_s8")
    ring_conv_w8a8.launches += 1
    return y


def _launch(x, kernel, packed, bias, out_dtype, amax=None, width=None) -> torch.Tensor:
    """The CUDA route: absmax (unless given) -> quantize -> s8 conv; under
    a width axis the absmax over the group and the halo'd quantize."""
    _check(x, "ring_conv_w8a8")
    if x.dim() != 4:
        raise ValueError(f"ring_conv_w8a8: expected NHWC x, got shape {tuple(x.shape)}")
    C = x.shape[3]
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, C):
        raise ValueError(f"ring_conv_w8a8: kernel shape {tuple(kernel.shape)} is not (3, 3, {C}, F)")
    wq, ks = packed if packed is not None else pack_weight(kernel)
    if tuple(wq.shape) != (kernel.shape[3], 9, padded_channels(C)) or tuple(ks.shape) != (kernel.shape[3],):
        raise ValueError(f"ring_conv_w8a8: packed weight {tuple(wq.shape)} is not the kernel's")
    if bias is not None and tuple(bias.shape) != (kernel.shape[3],):
        raise ValueError(f"ring_conv_w8a8: bias shape {tuple(bias.shape)} is not ({kernel.shape[3]},)")
    # every refusal before the first launch
    for t in (wq, ks) + ((bias,) if bias is not None else ()):
        if t.device != x.device:
            raise ValueError(f"ring_conv_w8a8: operands on {t.device} and {x.device}")
    if amax is None:
        amax = act_absmax(x, width)
    else:
        _check_amax(amax, x, "ring_conv_w8a8")
    halo = halo_exchange(x, 1, 1, width) if sharded(width) else None
    return ring_conv_s8(act_quantize(x, amax, halo=halo), amax, (wq, ks), bias, out_dtype)


def _no_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "ring_conv_w8a8: the int8 lane is inference-only (round has no gradient); "
            "run it under torch.no_grad() or torch.inference_mode()"
        )


def ring_conv_w8a8(x, kernel, bias, out_dtype: Optional[torch.dtype] = None, packed=None,
                   amax: Optional[torch.Tensor] = None, width=None) -> torch.Tensor:
    """3x3 ring conv in W8A8, NHWC: x (B, H, W, C) fp32 or bf16, kernel (3,
    3, C, F) HWIO (the fp32 master), bias (F,) or None; the output in
    ``out_dtype`` (x's dtype when None). On the CUDA route (absmax ->
    quantize -> s8 conv), ``packed`` is ``pack_weight(kernel)`` kept by the
    caller (packed here otherwise) and ``amax`` x's ``act_absmax`` when the
    caller has it (launched here otherwise); the plain version takes both
    from x and kernel. ``width``: the ``World`` whose width group holds the
    image's other columns (the module docstring)."""
    _no_grad(x, kernel, bias)
    out_dtype = out_dtype or x.dtype
    if x.device.type != "cpu":
        return _launch(x, kernel, packed, bias, out_dtype, amax, width)
    if not sharded(width):
        return ring_conv_w8a8_plain(x, kernel, bias, out_dtype)
    # under a width axis the plain versions of the three steps
    amax = act_absmax(x, width) if amax is None else amax
    xq = act_quantize(x, amax, halo=halo_exchange(x, 1, 1, width))
    return ring_conv_s8(xq, amax, pack_weight(kernel), bias, out_dtype)


def w8a8_accumulators(x, kernel, packed=None) -> torch.Tensor:
    """The s32 sums conv(ring_pad(xq), kq) alone, int32 (B, H, W, F): the
    three kernels, the conv without its epilogue, on a CUDA tensor (each
    launch counted), ``conv_s8`` on a CPU one."""
    _no_grad(x, kernel)
    if x.device.type == "cpu":
        return conv_s8(act_qparams(x)[0], weight_qparams(kernel)[0])
    return _launch(x, kernel, packed, None, torch.int32)


ring_conv_w8a8.launches = 0
act_absmax.launches = 0
act_quantize.launches = 0
act_quantize_halo.launches = 0
