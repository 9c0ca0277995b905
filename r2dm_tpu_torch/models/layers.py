"""Building blocks of the denoiser (NHWC), as ``nn.Module``s.

Same maths as the NHWC path of ``r2dm_tpu/models/layers.py``; parameters
carry the reference torch ``state_dict`` names (``norm1.weight``,
``conv1.weight`` in OIHW, ``norm2.proj.1.weight``,
``attn.in_proj_weight``, ...), so reference checkpoints load as they are.

Compute dtype: parameters stay fp32 and each op casts them to its compute
dtype (``dtype``, or the promoted input/parameter dtype when ``dtype`` is
None), as the JAX modules do. GroupNorm statistics and the SiLU run in fp32.
``ResidualBlock`` takes the structure of the JAX package's unfused path
(layers.py:731-760): ``fused_group_norm_silu`` writes the activated tensor
once, and ``fused_act_ringconv`` convolves it with ``apply_act=False``
(GN+SiLU -> conv -> AdaGN+SiLU -> [dropout] -> conv -> skip); on CUDA
tensors those calls are the hand-written kernels, under autograd too.

The int8 serving lane (the JAX package's ``layers.QUANT_CONV = "w8a8"``) is
a setting of each model, ``set_quant_conv(model, "w8a8")``: every 3x3
``RingConv`` built ``quantizable`` (all but the down convs, which the JAX
package composes with their FIR filter and keeps in bf16) then runs
``ops/quant.py::ring_conv_w8a8`` on the activation as it arrives, in the
JAX package's dtype at each site, with the output in the compute dtype.

The width axis is a setting of each model too, ``set_width_shard(model,
world)``: every module that pads the ring, normalises or attends then takes
the ``World`` whose width group splits the image's columns
(``width_shard``), and on its rank's columns computes what one rank computes
on the whole image: ``RingConv`` and the resamples pad W from the
neighbours' columns (``ops/pad.py::ring_pad``), ``ResidualBlock`` runs the
ring conv's halo'd form on the exchanged columns, ``GroupNorm``/``AdaGN``
take their statistics across the ranks, ``SelfAttention`` attends over
the keys and values of the whole image, and the int8 lane takes its absmax
across the ranks and quantizes the exchanged columns. Under autograd every
one of them is differentiable, and a rank's backward gives its own columns'
share of each parameter gradient (the trainer sums the shares over the
width group, ``training/step.py``). The RefineNet takes the same setting
(``models/refinenet.py``).

``FUSED_RESAMPLE`` is the JAX package's switch of the same name
(``r2dm_tpu/models/layers.py:470-475``), read by ``UNetBlock`` at each
call: True or "both", "down" (the default, as in JAX), "up", or False. A
level-boundary conv on a listed side runs composed with its FIR resample
(``RingConv.conv_then_downsample`` / ``upsample_then_conv``,
``ops/fused_resample.py``), in the compute dtype and never quantized, as
the JAX package's composed convs return before its int8 branch.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import fused_resample
from ..ops.act_ringconv import act_ringconv_sharded, fused_act_ringconv
from ..ops.gn_silu import fused_group_norm_silu, group_norm_silu_sharded
from ..ops.pad import ring_pad
from ..ops.quant import pack_weight, ring_conv_w8a8
from ..parallel.width import gather_columns, shard_columns, sharded

QUANT_MODES = (None, "w8a8")
# the down path composes its conv with the FIR filter; True/"both", "down",
# "up" or False (JAX models/layers.py:475)
FUSED_RESAMPLE = "down"
FUSED_DOWN = (True, "both", "down")
FUSED_UP = (True, "both", "up")
RESIDUAL_SCALE = float(1 / math.sqrt(2))


def _compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor, p: torch.Tensor) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, p.dtype)


def _scale_in(x: torch.Tensor, scale: float) -> float:
    """``scale`` rounded to x's dtype (JAX multiplies by jnp.asarray(scale,
    x.dtype))."""
    return float(torch.tensor(scale, dtype=x.dtype))


class Dense(nn.Linear):
    """Linear layer with the flax ``Dense(dtype=...)`` casting policy."""

    def __init__(self, in_features: int, out_features: int, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = _compute_dtype(self.compute_dtype, x, self.weight)
        return F.linear(x.to(cd), self.weight.to(cd), self.bias.to(cd))


class RingConv(nn.Module):
    """3x3 conv with circular W / zero H padding (reference ops.Conv2d,
    models/ops.py:149-173), or a 1x1 conv. NHWC in and out; the weight is
    OIHW like the reference's. ``quant``: None, or "w8a8" for the int8
    lane (only a 3x3 conv built ``quantizable``; ``set_quant_conv``)."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_size: int = 3,
        dtype: Optional[torch.dtype] = None, quantizable: bool = True,
    ):
        super().__init__()
        assert kernel_size in (1, 3)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.compute_dtype = dtype
        self.quantizable = quantizable and kernel_size == 3
        self.quant: Optional[str] = None
        self.width_shard = None  # set_width_shard: the World whose width group splits W
        self._packed = None  # (key, pack_weight(...)) of the int8 lane on the card
        self._composed = None  # (key, the composed down weight) when no gradient is taken

    def hwio(self) -> torch.Tensor:
        """The weight in the (kh, kw, C_in, F) layout of the JAX kernels."""
        return self.weight.permute(2, 3, 1, 0)

    def packed_s8(self):
        """The weight quantized and packed for the s8 kernel, made again only
        when the weight changes (its version counter, device or storage)."""
        w = self.weight
        key = (w._version, w.device, w.data_ptr())
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_weight(self.hwio()))
        return self._packed[1]

    def _resample_operands(self, x: torch.Tensor):
        """x and the HWIO weight in the JAX package's composed-conv dtypes:
        x in the compute dtype (as it arrives without one), the kernel in
        x's (JAX layers.py:81-82)."""
        x = x.to(self.compute_dtype) if self.compute_dtype is not None else x
        return x, self.hwio().to(x.dtype)

    def conv_then_downsample(self, x: torch.Tensor) -> torch.Tensor:
        """== downsample2x(self(x)) as one stride-2 6x6 conv. Under autograd
        with a weight that takes a gradient the composed kernel is built in
        the graph, so dW flows to the 3x3 weight; otherwise it is kept and
        built again only when the weight changes (its version counter,
        device, storage) or the dtype does."""
        x, k = self._resample_operands(x)
        w = self.weight
        if torch.is_grad_enabled() and w.requires_grad:
            return fused_resample.conv_then_downsample(x, k, self.bias, width=self.width_shard)
        key = (w._version, w.device, w.data_ptr(), k.dtype, torch.is_inference_mode_enabled())
        if self._composed is None or self._composed[0] != key:
            with torch.no_grad():
                self._composed = (key, fused_resample.down_weight(k))
        return fused_resample.conv_then_downsample(x, k, self.bias, weight=self._composed[1],
                                                   width=self.width_shard)

    def upsample_then_conv(self, x: torch.Tensor) -> torch.Tensor:
        """== self(upsample2x(x)), composed (``FUSED_RESAMPLE`` "up"/"both")."""
        x, k = self._resample_operands(x)
        return fused_resample.upsample_then_conv(x, k, self.bias, width=self.width_shard)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant == "w8a8":
            # quantized from the fp32 master weight and the activation as it
            # arrives (JAX layers.py:116-123); the output in the compute dtype
            return ring_conv_w8a8(x, self.hwio(), self.bias, out_dtype=self.compute_dtype or x.dtype,
                                  packed=self.packed_s8() if x.is_cuda else None, width=self.width_shard)
        cd = _compute_dtype(self.compute_dtype, x, self.weight)
        x = x.to(cd)
        if self.weight.shape[-1] == 3:
            x = ring_pad(x, 1, width=self.width_shard)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(cd), self.bias.to(cd))
        return y.permute(0, 2, 3, 1).contiguous()


class GroupNorm(nn.Module):
    """Affine GroupNorm (torch nn.GroupNorm semantics), followed by SiLU when
    ``silu`` (JAX's ``silu`` field), through the ``fused_group_norm_silu``
    kernel."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6, silu: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.silu = silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.width_shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.width_shard is not None:
            return group_norm_silu_sharded(x, self.weight, self.bias, self.num_groups, self.eps, self.silu,
                                           self.width_shard)
        return fused_group_norm_silu(
            x, self.weight, self.bias, self.num_groups, self.eps, apply_silu=self.silu
        )


class AdaGN(nn.Module):
    """Adaptive GroupNorm (reference ops.AdaGN, models/ops.py:176-200):
    non-affine GN, then h*(1 + scale) + shift with (scale, shift) =
    Linear(SiLU(emb)) split in that order, then SiLU when ``silu``: one
    ``fused_group_norm_silu`` with (B, C) gain 1 + scale and shift."""

    def __init__(
        self, num_groups: int, num_channels: int, emb_channels: int,
        eps: float = 1e-6, dtype: Optional[torch.dtype] = None, silu: bool = False,
    ):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.silu = silu
        self.proj = nn.Sequential(nn.SiLU(), Dense(emb_channels, 2 * num_channels, dtype=dtype))
        self.width_shard = None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.proj(emb).chunk(2, dim=-1)
        gain = 1.0 + scale.to(torch.float32)
        if self.width_shard is not None:
            return group_norm_silu_sharded(x, gain, shift.to(torch.float32), self.num_groups, self.eps, self.silu,
                                           self.width_shard)
        return fused_group_norm_silu(
            x, gain, shift.to(torch.float32), self.num_groups, self.eps, apply_silu=self.silu
        )


class SelfAttention(nn.Module):
    """Multi-head self-attention over the (H*W) tokens, torch
    nn.MultiheadAttention parameters (packed q, k, v projection). Logits in
    fp32 scaled by 1/sqrt(head_dim), softmax, weights cast to v's dtype
    (layers.py:616-643); plain matmul + softmax so rounding follows JAX.
    Under a width axis the queries are this rank's pixels and the keys and
    values the whole image's, gathered over the width group in column order:
    each query meets the same keys in the same order as on one rank."""

    def __init__(self, channels: int, num_heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * channels, channels))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * channels))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = Dense(channels, channels, dtype=dtype)
        nn.init.zeros_(self.out_proj.weight)
        nn.init.zeros_(self.out_proj.bias)
        self.width_shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h = x.reshape(B, H * W, C)
        qkv = h @ self.in_proj_weight.T.to(h.dtype) + self.in_proj_bias.to(h.dtype)
        q, k, v = qkv.chunk(3, dim=-1)
        hd = C // self.num_heads
        if self.width_shard is not None:  # the whole image's keys and values
            k, v = (gather_columns(t.reshape(B, H, W, C), self.width_shard).reshape(B, -1, C) for t in (k, v))

        def heads(t):
            return t.reshape(B, -1, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        logits = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (weights @ v).transpose(1, 2).reshape(B, H * W, C)
        return self.out_proj(out).reshape(B, H, W, C)


class SelfAttentionBlock(nn.Module):
    """Pre-norm attention with (x + attn(norm(x))) / sqrt(2) (reference
    models/efficient_unet.py:23-53)."""

    def __init__(
        self, channels: int, num_heads: int, gn_num_groups: int = 8,
        gn_eps: float = 1e-6, dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.norm = GroupNorm(gn_num_groups, channels, gn_eps)
        self.attn = SelfAttention(channels, num_heads, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(self.norm(x))
        return (x + h) * _scale_in(x, RESIDUAL_SCALE)


def apply_dropout(h: torch.Tensor, p: float, generator: Optional[torch.Generator], width=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each value with probability 1 - p (a
    Bernoulli mask drawn from ``generator``) and scale the kept ones by
    1 / (1 - p), in h's dtype. Under a width axis (``width``) the mask is
    drawn for the whole image and cut to the rank's columns, as the noise
    is: one rank's mask."""
    shape = tuple(h.shape)
    if sharded(width):
        shape = (*shape[:2], shape[2] * width.width_size, *shape[3:])
    keep = shard_columns(torch.rand(shape, generator=generator, device=h.device) < 1.0 - p, width)
    return torch.where(keep, h / (1.0 - p), torch.zeros((), dtype=h.dtype, device=h.device))


class ResidualBlock(nn.Module):
    """GN-SiLU-Conv x2 residual block with AdaGN time conditioning
    (reference models/efficient_unet.py:56-110): zero-init second conv, 1x1
    skip when channels change, (skip + h) / sqrt(2). With ``dropout`` > 0 and
    the module in training mode, dropout between norm2 and conv2 (JAX
    layers.py:750-751), its mask from the ``generator`` passed to forward."""

    def __init__(
        self, in_channels: int, out_channels: int, emb_channels: int,
        gn_num_groups: int = 8, gn_eps: float = 1e-6, dtype: Optional[torch.dtype] = None,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.compute_dtype = dtype
        self.dropout = dropout
        self.norm1 = GroupNorm(gn_num_groups, in_channels, gn_eps, silu=True)
        self.conv1 = RingConv(in_channels, out_channels, dtype=dtype)
        self.norm2 = AdaGN(gn_num_groups, out_channels, emb_channels, gn_eps, dtype=dtype, silu=True)
        self.conv2 = RingConv(out_channels, out_channels, dtype=dtype)
        nn.init.zeros_(self.conv2.weight)
        self.skip = (
            RingConv(in_channels, out_channels, kernel_size=1, dtype=dtype)
            if in_channels != out_channels else None
        )
        self.width_shard = None

    def _conv(self, conv: RingConv, h: torch.Tensor) -> torch.Tensor:
        if conv.quant is not None:
            return conv(h)
        hc = h.to(self.compute_dtype) if self.compute_dtype is not None else h
        if self.width_shard is None:
            return fused_act_ringconv(hc, None, None, conv.hwio(), conv.bias, apply_act=False)
        return act_ringconv_sharded(hc, conv.hwio(), conv.bias, self.width_shard)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self._conv(self.conv1, self.norm1(x))
        h = self.norm2(h, emb)
        if self.dropout > 0.0 and self.training:
            h = apply_dropout(h, self.dropout, generator, self.width_shard)
        h = self._conv(self.conv2, h)
        skip = self.skip(x) if self.skip is not None else x
        return (skip + h) * _scale_in(h, RESIDUAL_SCALE)


def set_quant_conv(model: nn.Module, mode: Optional[str]) -> nn.Module:
    """Turn the int8 serving lane of ``model`` on ("w8a8") or off (None):
    every quantizable 3x3 ``RingConv`` in it (the JAX package's
    ``layers.QUANT_CONV``, a global there). Inference-only: the lane raises
    under autograd. Returns the model."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {mode!r}; one of {QUANT_MODES}")
    for m in model.modules():
        if isinstance(m, RingConv) and m.quantizable:
            m.quant = mode
    return model


def quant_conv_mode(model: nn.Module) -> Optional[str]:
    """The lane ``set_quant_conv`` set on ``model`` (None when it is off)."""
    return next((m.quant for m in model.modules() if isinstance(m, RingConv) and m.quant), None)


def width_shard_of(model: nn.Module):
    """The ``World`` ``set_width_shard`` set on ``model`` (None: no width
    axis)."""
    return next((m.width_shard for m in model.modules() if getattr(m, "width_shard", None) is not None), None)


def set_width_shard(model: nn.Module, world) -> nn.Module:
    """Run ``model`` on the columns its rank holds of a width axis over
    ``world``'s width group (None, or a world of width 1: the whole image):
    every module that pads the ring, normalises or attends takes the group.
    The model checks that its levels split (its ``check_width_shard``
    raises). Returns the model."""
    shard = world if sharded(world) else None
    if shard is not None:
        model.check_width_shard(shard.width_size)
    for m in model.modules():
        if hasattr(m, "width_shard"):
            m.width_shard = shard
    return model


@contextlib.contextmanager
def width_sharded(model: nn.Module, world):
    """``set_width_shard(model, world)`` for the body, then back to the
    model's own setting."""
    before = width_shard_of(model)
    set_width_shard(model, world)
    try:
        yield model
    finally:
        set_width_shard(model, before)
