"""Fused (affine + SiLU) prologue + 3x3 ring convolution, NHWC: the CUDA
kernel ``csrc/act_ringconv.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``r2dm_tpu/ops/pallas_resconv.py::fused_act_ringconv``
with the same signature and layouts:

    y = ring_conv3x3(silu(x * a + b), kernel) + bias     # apply_act=True
    y = ring_conv3x3(x, kernel) + bias                    # apply_act=False

x (B, H, W, C) NHWC; a, b (B, C) fp32; kernel (3, 3, C, F) HWIO; bias (F,).
W wraps circularly; H is zero-padded AFTER the activation. A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.
``fused_act_ringconv.launches`` counts kernel launches, and
``fused_act_ringconv.tile_launches`` counts them by tile variant.

The kernel is one template instantiated for a few tile variants (``TILES``:
BM output pixels x BN output channels, BK input channels a slice; the
wrapper passes the geometry, and the kernel refuses one it was not built
for). ``tile_variant`` picks one from the shape and the card's SM count and
caches the choice per shape, so a launch costs the host one dictionary
lookup more: 256 x 64 at F <= 64, 128 x 256 at F > 128 where that still
gives every SM a tile, else 128 x 128. Each launch first packs the weight
for the chosen variant (``pack_weight``'s layout), reading it where it lies
(a parameter's ``hwio()`` view, fp32 or bf16), so the wrapper makes no copy
of its own.

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

# the weight as the kernel's pack reads it: the HWIO view's pointer, its
# strides in elements, fp32 (else bf16)
_WEIGHT = [ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_int]
_ARGS = [ctypes.c_void_p] * 3 + _WEIGHT + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_HALO_ARGS = [ctypes.c_void_p] * 5 + _WEIGHT + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_PACK_ARGS = _WEIGHT + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2

# the kernel's tile variants, the instantiations of csrc/act_ringconv.cu:
# name -> (BM output pixels, BN output channels, BK input channels a slice)
TILES = {
    "m256n64": (256, 64, 32),
    "m128n128": (128, 128, 32),
    "m128n256": (128, 256, 16),
}
_tiles: dict[tuple, str] = {}
_sms: dict = {}


def _lib():
    lib = build.load("act_ringconv")
    if lib.act_ringconv_launch.argtypes is None:
        lib.act_ringconv_launch.argtypes = _ARGS
        lib.act_ringconv_launch.restype = ctypes.c_int
        lib.act_ringconv_halo_launch.argtypes = _HALO_ARGS
        lib.act_ringconv_halo_launch.restype = ctypes.c_int
        lib.act_ringconv_pack.argtypes = _PACK_ARGS
        lib.act_ringconv_pack.restype = ctypes.c_int
    return lib


def sm_count(device) -> int:
    """The SMs of a CUDA device (the persistent grid is min(tiles, SMs)
    blocks), read once a device."""
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def tile_count(tile: str, B: int, H: int, W: int, F: int) -> int:
    """The tiles (units of work of the persistent grid) of one launch."""
    bm, bn, _ = TILES[tile]
    return B * H * -(-W // bm) * -(-F // bn)


def _choose_tile(B: int, H: int, W: int, C: int, F: int, sms: int) -> str:
    if F <= 64:
        return "m256n64"
    if F > 128 and tile_count("m128n256", B, H, W, F) >= sms:
        return "m128n256"
    return "m128n128"


def tile_variant(B: int, H: int, W: int, C: int, F: int, sms: int) -> str:
    """The tile variant of a launch on x (B, H, W, C) into F channels on a
    card of ``sms`` SMs: 256 pixels x 64 channels at F <= 64; at F > 128
    256 channels where that still gives every SM a tile (a wider N tile
    reads each staged byte for more products), else 128 x 128. Chosen once
    per shape."""
    key = (B, H, W, C, F, sms)
    tile = _tiles.get(key)
    if tile is None:
        tile = _tiles[key] = _choose_tile(B, H, W, C, F, sms)
    return tile


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


def _packed_shape(tile: str, C: int, Fo: int) -> tuple:
    _, bn, bk = TILES[tile]
    return (-(-Fo // bn), 3, -(-C // bk), 3, bk // 8, bn, 8)


def _packable(kernel):
    """An HWIO weight as the kernel's pack reads it: fp32 or bf16, at any
    strides. Keep it alive until the launch is enqueued."""
    return kernel if kernel.dtype in (torch.float32, torch.bfloat16) else kernel.float()


def _weight_args(kernel) -> tuple:
    return (kernel.data_ptr(), *kernel.stride(), int(kernel.dtype == torch.float32))


def pack_weight(kernel, tile: str, dtype=torch.bfloat16):
    """HWIO (3, 3, C, F) -> the layout tile variant ``tile`` (BN, BK) reads,
    in ``dtype``: [F/BN][3 kh][C/BK][3 kw][BK/8][BN][8], C and F zero-padded
    to multiples of BK and BN. One slice of the kernel's K loop (an N tile,
    a kernel row, BK input channels) is then one contiguous run, which the
    kernel brings in with one bulk copy, already in the no-swizzle K-major
    layout its products read: per tap, 16-byte rows of 8 input channels of
    one output channel, the BN rows of a channel chunk together.

    On a CUDA tensor (bf16 only) this is the kernel's own pack, the first
    kernel of every launch, which reads the weight at its strides (a
    parameter's ``hwio()`` view) and casts in the same pass; on a CPU tensor
    the same layout in PyTorch, one copy where no padding is needed."""
    if kernel.is_cuda:
        if dtype != torch.bfloat16:
            raise TypeError(f"act_ringconv: the kernel's pack writes bfloat16, not {dtype}")
        C, Fo = kernel.shape[2], kernel.shape[3]
        packed = torch.empty(_packed_shape(tile, C, Fo), dtype=dtype, device=kernel.device)
        lib, k = _lib(), _packable(kernel)
        rc = lib.act_ringconv_pack(*_weight_args(k), C, Fo, *TILES[tile], packed.data_ptr(),
                                   build.stream_ptr(kernel.device))
        build.check(lib, rc, "act_ringconv.pack_weight")
        return packed
    _, bn, bk = TILES[tile]
    C, Fo = kernel.shape[2], kernel.shape[3]
    Cp, Fp = -(-C // bk) * bk, -(-Fo // bn) * bn
    if (Cp, Fp) != (C, Fo):
        kernel = F.pad(kernel, (0, Fp - Fo, 0, Cp - C))
    s = kernel.stride()
    # (kh, kw, c, f) seen as (n tile, kh, c slice, kw, chunk, n, c in chunk)
    view = kernel.as_strided(_packed_shape(tile, Cp, Fp),
                             (bn * s[3], s[0], bk * s[2], s[1], 8 * s[2], s[3], s[2]), kernel.storage_offset())
    packed = torch.empty(view.shape, dtype=dtype, device=kernel.device)
    packed.copy_(view)
    return packed


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
    tile = tile_variant(B, H, W, C, Fo, sm_count(x.device))
    # the launch packs the weight into w (its first kernel), then convolves
    k = _packable(kernel)
    w = torch.empty(_packed_shape(tile, C, Fo), dtype=torch.bfloat16, device=x.device)
    bias32 = bias.to(torch.float32).contiguous()
    y = torch.empty((B, H, W, Fo), dtype=torch.bfloat16, device=x.device)
    pa = a.data_ptr() if apply_act else None
    pb = b.data_ptr() if apply_act else None
    tail = (*_weight_args(k), w.data_ptr(), bias32.data_ptr(), y.data_ptr(), B, H, W, C, Fo, int(apply_act),
            *TILES[tile], build.stream_ptr(x.device))
    if halo is None:
        rc = lib.act_ringconv_launch(x.data_ptr(), pa, pb, *tail)
        build.check(lib, rc, "fused_act_ringconv")
        counted = fused_act_ringconv
    else:
        rc = lib.act_ringconv_halo_launch(x.data_ptr(), halo[0].data_ptr(), halo[1].data_ptr(), pa, pb, *tail)
        build.check(lib, rc, "act_ringconv_halo")
        counted = act_ringconv_halo
    counted.launches += 1
    counted.tile_launches[tile] += 1
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
fused_act_ringconv.tile_launches = dict.fromkeys(TILES, 0)
act_ringconv_halo.tile_launches = dict.fromkeys(TILES, 0)
