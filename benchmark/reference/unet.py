"""The plain float32 EfficientUNet of R2DM (config H), the benchmark's reference.

Written from the published network (kazuto1011/r2dm ``models/efficient_unet.py``
and ``models/ops.py``): ring padding (W wraps, H is zero-padded), AdaGN time
conditioning, self-attention at the bottleneck, concat skips, 1/sqrt(2)
residual scaling, Fourier features of the sensor's ray angles concatenated to
the input, and the anti-aliased FIR [1, 3, 3, 1] down/upsampling. Parameters
carry the reference ``state_dict`` names. Every operation is a plain PyTorch
call in NCHW float32: no kernel, no cache, no batching trick. It imports
nothing of the program under test.

``quant`` (None, or "fp8"): the control of the correctness check. Each
convolution and matrix product then rounds its operands to float8 e4m3
(a per-tensor scale to the format's range), the precision below bfloat16.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import q8

FIR_TAPS = (1.0, 3.0, 3.0, 1.0)


def ring_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """NCHW: W padded circularly, H with zeros."""
    x = torch.cat([x[..., -p:], x, x[..., :p]], dim=3)
    return F.pad(x, (0, 0, p, p))


def fir(up: int, channels: int, device) -> torch.Tensor:
    """The depthwise (channels, 1, 4, 4) filter: the normalised taps' outer
    product, times up^2 so that zero insertion keeps the mean."""
    k = torch.tensor(FIR_TAPS, dtype=torch.float32, device=device)
    k = k / k.sum() * up
    return torch.outer(k, k).expand(channels, 1, 4, 4)


def downsample2x(x: torch.Tensor) -> torch.Tensor:
    """Reference Resample(down=2): ring margin 1, the 4x4 filter, stride 2."""
    return F.conv2d(ring_pad(x, 1), fir(1, x.shape[1], x.device), stride=2, groups=x.shape[1])


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Reference Resample(up=2): ring margin 2, zeros inserted between
    samples, 2 samples cropped at each end, the 4x4 filter."""
    x = ring_pad(x, 2)
    B, C, H, W = x.shape
    z = x.new_zeros(B, C, 2 * H - 1, 2 * W - 1)
    z[:, :, ::2, ::2] = x
    z = z[:, :, 2:-2, 2:-2]
    return F.conv2d(z, fir(2, C, x.device), groups=C)


class Conv(nn.Module):
    """A 3x3 ring conv or a 1x1 conv, OIHW weight."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.quant: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.shape[-1] == 3:
            x = ring_pad(x, 1)
        return F.conv2d(q8(x, self.quant), q8(self.weight, self.quant), self.bias)


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.quant: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(q8(x, self.quant), q8(self.weight, self.quant), self.bias)


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.groups, self.weight, self.bias, self.eps)


class AdaGN(nn.Module):
    """Non-affine GroupNorm, then h * (1 + scale) + shift, (scale, shift) =
    Linear(SiLU(emb)), then SiLU."""

    def __init__(self, groups: int, channels: int, emb: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.proj = nn.Sequential(nn.SiLU(), Linear(emb, 2 * channels))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.proj(emb).chunk(2, dim=1)
        h = F.group_norm(x, self.groups, eps=self.eps)
        return F.silu(h * (1.0 + scale[:, :, None, None]) + shift[:, :, None, None])


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb: int, groups: int, eps: float):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps)
        self.conv1 = Conv(cin, cout)
        self.norm2 = AdaGN(groups, cout, emb, eps)
        self.conv2 = Conv(cout, cout)
        self.skip = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(self.norm2(h, emb))
        skip = self.skip(x) if self.skip is not None else x
        return (skip + h) / math.sqrt(2.0)


class SelfAttention(nn.Module):
    """torch nn.MultiheadAttention's parameters: packed q, k, v."""

    def __init__(self, channels: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * channels, channels))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * channels))
        self.out_proj = Linear(channels, channels)
        self.quant: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = x.flatten(2).transpose(1, 2)  # (B, HW, C)
        qkv = F.linear(q8(h, self.quant), q8(self.in_proj_weight, self.quant), self.in_proj_bias)
        q, k, v = (t.reshape(B, H * W, self.heads, C // self.heads).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        logits = q8(q, self.quant) @ q8(k, self.quant).transpose(-1, -2) / math.sqrt(C // self.heads)
        out = q8(torch.softmax(logits, dim=-1), self.quant) @ q8(v, self.quant)
        out = self.out_proj(out.transpose(1, 2).reshape(B, H * W, C))
        return out.transpose(1, 2).reshape(B, C, H, W)


class SelfAttentionBlock(nn.Module):
    def __init__(self, channels: int, heads: int, groups: int, eps: float):
        super().__init__()
        self.norm = GroupNorm(groups, channels, eps)
        self.attn = SelfAttention(channels, heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x + self.attn(self.norm(x))) / math.sqrt(2.0)


class Down(nn.Sequential):
    """``downsample.0`` is the conv; ``downsample.1`` the FIR filter."""

    def __init__(self, cin: int, cout: int):
        super().__init__(Conv(cin, cout), nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return downsample2x(self[0](x))


class Up(nn.Sequential):
    """``upsample.0`` is the FIR filter; ``upsample.1`` the conv."""

    def __init__(self, channels: int):
        super().__init__(nn.Identity(), Conv(channels, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self[1](upsample2x(x))


class UNetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, emb: int, groups: int, eps: float, heads: int,
                 down: bool = False, up: bool = False, attn: bool = False):
        super().__init__()
        self.downsample = Down(cin, cout) if down else None
        cin = cout if down else cin
        self.residual_blocks = nn.ModuleList(
            ResidualBlock(cin if i == 0 else cout, cout, emb, groups, eps) for i in range(n))
        self.self_attn_block = SelfAttentionBlock(cout, heads, groups, eps) if attn else None
        self.upsample = Up(cout) if up else None

    def forward(self, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            h = self.downsample(h)
        for block in self.residual_blocks:
            h = block(h, emb)
        if self.self_attn_block is not None:
            h = self.self_attn_block(h)
        if self.upsample is not None:
            h = self.upsample(h)
        return h


def hdl64e_angles(H: int, W: int, device=None) -> torch.Tensor:
    """(1, 2, H, W) ray angles in radians of the HDL-64E's linear model:
    elevation +3 .. -25 degrees down the rows, azimuth +180 .. -180 degrees
    along the columns (reference utils/lidar.py)."""
    elevation = (1 - torch.arange(H, dtype=torch.float64) / H) * 28.0 - 25.0
    azimuth = (1 - torch.arange(W, dtype=torch.float64) / W) * 360.0 - 180.0
    el, az = torch.meshgrid(elevation, azimuth, indexing="ij")
    return torch.deg2rad(torch.stack([el, az])[None]).to(device=device, dtype=torch.float32)


def fourier_frequencies(H: int, W: int) -> torch.Tensor:
    """(L_h + L_w, 2): log2-spaced frequencies, the first ceil(log2 H) on
    the elevation, the rest on the azimuth."""
    lh, lw = math.ceil(math.log2(H)), math.ceil(math.log2(W))
    f = torch.zeros(lh + lw, 2)
    f[:lh, 0] = 2.0 ** torch.arange(lh)
    f[lh:, 1] = 2.0 ** torch.arange(lw)
    return f


def timestep_embedding(t: torch.Tensor, channels: int) -> torch.Tensor:
    half = channels // 2
    freqs = torch.exp(-math.log(10_000.0) / (half - 1) * torch.arange(half, dtype=torch.float32, device=t.device))
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


class TimeEmbedding(nn.Sequential):
    """``time_embedding.{1,3}``: sinusoid -> Linear -> SiLU -> Linear."""

    def __init__(self, base: int, emb: int):
        super().__init__(nn.Identity(), Linear(base, emb), nn.SiLU(), Linear(emb, emb))
        self.base = base

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self[3](self[2](self[1](timestep_embedding(t, self.base))))


class EfficientUNet(nn.Module):
    """forward(x NHWC (B, H, W, C), condition (B,)) -> NHWC float32, the
    program's calling convention; NCHW inside."""

    def __init__(self, in_channels: int = 2, resolution: Sequence[int] = (64, 1024), base_channels: int = 64,
                 channel_multiplier: Sequence[int] = (1, 2, 4, 8), num_residual_blocks: Sequence[int] = (3, 3, 3, 3),
                 gn_num_groups: int = 8, gn_eps: float = 1e-6, attn_num_heads: int = 8):
        super().__init__()
        H, W = resolution
        self.resolution = (H, W)
        self.register_buffer("coords", hdl64e_angles(H, W))
        self.register_buffer("freqs", fourier_frequencies(H, W), persistent=False)
        emb = 4 * base_channels
        C = [base_channels] + [base_channels * m for m in channel_multiplier]
        N = list(num_residual_blocks)
        kw = dict(emb=emb, groups=gn_num_groups, eps=gn_eps, heads=attn_num_heads)
        self.time_embedding = TimeEmbedding(base_channels, emb)
        self.in_conv = Conv(in_channels + 2 * len(self.freqs), C[0])
        self.d_block1 = UNetBlock(C[0], C[1], N[0], **kw)
        self.d_block2 = UNetBlock(C[1], C[2], N[1], down=True, **kw)
        self.d_block3 = UNetBlock(C[2], C[3], N[2], down=True, **kw)
        self.d_block4 = UNetBlock(C[3], C[4], N[3], down=True, attn=True, **kw)
        self.u_block4 = UNetBlock(C[4], C[3], N[3], up=True, attn=True, **kw)
        self.u_block3 = UNetBlock(2 * C[3], C[2], N[2], up=True, **kw)
        self.u_block2 = UNetBlock(2 * C[2], C[1], N[1], up=True, **kw)
        self.u_block1 = UNetBlock(2 * C[1], C[0], N[0], **kw)
        self.out_conv = Conv(C[0], in_channels)

    def set_quant(self, quant: Optional[str]) -> "EfficientUNet":
        for m in self.modules():
            if hasattr(m, "quant"):
                m.quant = quant
        return self

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        emb = self.time_embedding(condition.expand(B) if condition.dim() == 0 else condition)
        proj = torch.einsum("chw,fc->fhw", self.coords[0], self.freqs)
        enc = torch.cat([torch.sin(proj), torch.cos(proj)])[None].expand(B, -1, -1, -1)
        h = self.in_conv(torch.cat([x.permute(0, 3, 1, 2).float(), enc], dim=1))
        h1 = self.d_block1(h, emb)
        h2 = self.d_block2(h1, emb)
        h3 = self.d_block3(h2, emb)
        h4 = self.d_block4(h3, emb)
        h = self.u_block4(h4, emb)
        h = self.u_block3(torch.cat([h, h3], dim=1), emb)
        h = self.u_block2(torch.cat([h, h2], dim=1), emb)
        h = self.u_block1(torch.cat([h, h1], dim=1), emb)
        return self.out_conv(h).permute(0, 2, 3, 1)
