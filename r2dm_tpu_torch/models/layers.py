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
(GN+SiLU -> conv -> AdaGN+SiLU -> conv -> skip); on CUDA tensors those calls
are the hand-written kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.act_ringconv import fused_act_ringconv
from ..ops.gn_silu import fused_group_norm_silu
from ..ops.pad import ring_pad

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
    OIHW like the reference's."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_size: int = 3,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        assert kernel_size in (1, 3)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.compute_dtype = dtype

    def hwio(self) -> torch.Tensor:
        """The weight in the (kh, kw, C_in, F) layout of the JAX kernels."""
        return self.weight.permute(2, 3, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = _compute_dtype(self.compute_dtype, x, self.weight)
        x = x.to(cd)
        if self.weight.shape[-1] == 3:
            x = ring_pad(x, 1)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.proj(emb).chunk(2, dim=-1)
        gain = 1.0 + scale.to(torch.float32)
        return fused_group_norm_silu(
            x, gain, shift.to(torch.float32), self.num_groups, self.eps, apply_silu=self.silu
        )


class SelfAttention(nn.Module):
    """Multi-head self-attention over the (H*W) tokens, torch
    nn.MultiheadAttention parameters (packed q, k, v projection). Logits in
    fp32 scaled by 1/sqrt(head_dim), softmax, weights cast to v's dtype
    (layers.py:616-643); plain matmul + softmax so rounding follows JAX."""

    def __init__(self, channels: int, num_heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * channels, channels))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * channels))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = Dense(channels, channels, dtype=dtype)
        nn.init.zeros_(self.out_proj.weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h = x.reshape(B, H * W, C)
        qkv = h @ self.in_proj_weight.T.to(h.dtype) + self.in_proj_bias.to(h.dtype)
        q, k, v = qkv.chunk(3, dim=-1)
        hd = C // self.num_heads

        def heads(t):
            return t.reshape(B, H * W, self.num_heads, hd).transpose(1, 2)

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


class ResidualBlock(nn.Module):
    """GN-SiLU-Conv x2 residual block with AdaGN time conditioning
    (reference models/efficient_unet.py:56-110): zero-init second conv, 1x1
    skip when channels change, (skip + h) / sqrt(2)."""

    def __init__(
        self, in_channels: int, out_channels: int, emb_channels: int,
        gn_num_groups: int = 8, gn_eps: float = 1e-6, dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.compute_dtype = dtype
        self.norm1 = GroupNorm(gn_num_groups, in_channels, gn_eps, silu=True)
        self.conv1 = RingConv(in_channels, out_channels, dtype=dtype)
        self.norm2 = AdaGN(gn_num_groups, out_channels, emb_channels, gn_eps, dtype=dtype, silu=True)
        self.conv2 = RingConv(out_channels, out_channels, dtype=dtype)
        nn.init.zeros_(self.conv2.weight)
        self.skip = (
            RingConv(in_channels, out_channels, kernel_size=1, dtype=dtype)
            if in_channels != out_channels else None
        )

    def _conv(self, conv: RingConv, h: torch.Tensor) -> torch.Tensor:
        hc = h.to(self.compute_dtype) if self.compute_dtype is not None else h
        return fused_act_ringconv(hc, None, None, conv.hwio(), conv.bias, apply_act=False)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self._conv(self.conv1, self.norm1(x))
        h = self._conv(self.conv2, self.norm2(h, emb))
        skip = self.skip(x) if self.skip is not None else x
        return (skip + h) * _scale_in(h, RESIDUAL_SCALE)
