"""The plain float32 LiDARGen RefineNet, the benchmark's reference.

Written from kazuto1011/r2dm ``models/refinenet.py`` (the LiDARGen baseline,
NCSN-style): circular 3x3 convolutions on both axes (the input and output
convs zero-padded), InstanceNorm2d+ (the instance norm scaled by the
per-channel means standardised over the channels, times alpha, then a
per-channel affine stored as a depthwise 1x1 conv), residual blocks that
average-pool (level 2) or dilate by 2 and 4 (levels 3 and 4), and a RefineNet
decoder of residual conv units, chained residual pooling (5x5 max pools) and
bilinear align_corners=True fusion. Reference ``state_dict`` names, NCHW
float32, plain PyTorch calls only; the timestep is ignored, as in LiDARGen.

``quant`` "fp8" is the control's precision (``precision.q8``) on every conv.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import q8

EPS = 1e-5


class Conv(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int = 3, padding: int = 1, dilation: int = 1, bias: bool = True,
                 circular: bool = True):
        super().__init__(cin, cout, k, dilation=dilation, bias=bias)
        self.p, self.circular = padding, circular
        self.quant: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.p:
            x = F.pad(x, (self.p,) * 4, mode="circular" if self.circular else "constant")
        return F.conv2d(q8(x, self.quant), q8(self.weight, self.quant), self.bias, dilation=self.dilation)


class PostAffine(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(channels))


class InstanceNormPlus(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.post_affine = PostAffine(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean_hw = x.mean(dim=(2, 3), keepdim=True)
        var_hw = ((x - mean_hw) ** 2).mean(dim=(2, 3), keepdim=True)
        m = mean_hw.mean(dim=1, keepdim=True)
        v = mean_hw.var(dim=1, keepdim=True, correction=1)
        h = (x - mean_hw) / torch.sqrt(var_hw + EPS) * self.alpha * ((mean_hw - m) / torch.sqrt(v + EPS))
        return h * self.post_affine.weight.view(1, -1, 1, 1) + self.post_affine.bias.view(1, -1, 1, 1)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, resample: Optional[str] = None, dilation: int = 1):
        super().__init__()
        mid = cin if resample == "down" else cout
        kw = dict(padding=dilation, dilation=dilation)
        pool = dilation == 1 and resample is not None
        self.norm1 = InstanceNormPlus(cin)
        self.conv1 = Conv(cin, mid, **kw)
        self.norm2 = InstanceNormPlus(mid)
        self.conv2 = nn.Sequential(Conv(mid, cout, **kw), nn.AvgPool2d(2)) if pool else Conv(mid, cout, **kw)
        self.skip = None
        if cin != cout or resample is not None:
            skip = Conv(cin, cout, 1, padding=0) if dilation == 1 else Conv(cin, cout, **kw)
            self.skip = nn.Sequential(skip, nn.AvgPool2d(2)) if pool else skip

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(F.elu(self.norm2(self.conv1(F.elu(self.norm1(x))))))
        return (self.skip(x) if self.skip is not None else x) + h


class RCU(nn.Module):
    """``units.j`` = (ELU, conv, ELU, conv), each added to its input."""

    def __init__(self, channels: int, blocks: int = 2):
        super().__init__()
        self.units = nn.ModuleList(
            nn.Sequential(nn.ELU(), Conv(channels, channels, bias=False), nn.ELU(), Conv(channels, channels, bias=False))
            for _ in range(blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for unit in self.units:
            x = x + unit(x)
        return x


class CRP(nn.Module):
    """``convs.i`` = (5x5 max pool, conv), chained on ELU(x)."""

    def __init__(self, channels: int, stages: int = 2):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Sequential(nn.MaxPool2d(5, 1, 2), Conv(channels, channels, bias=False)) for _ in range(stages))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.elu(x)
        for conv in self.convs:
            h = h + conv(h)
        return h


class RefineBlock(nn.Module):
    def __init__(self, cins: Sequence[int], cout: int, end_blocks: int = 1):
        super().__init__()
        multi = len(cins) > 1
        self.adaptive_convs = nn.ModuleList(
            nn.Sequential(RCU(c), *([Conv(c, cout)] if multi else [])) for c in cins)
        self.crp = CRP(cout)
        self.output_conv = RCU(cout, end_blocks)

    def forward(self, xs, shape) -> torch.Tensor:
        h = sum(F.interpolate(adapt(x), size=tuple(shape), mode="bilinear", align_corners=True)
                for adapt, x in zip(self.adaptive_convs, xs))
        return self.output_conv(self.crp(h))


class RefineNet(nn.Module):
    """forward(x NHWC, condition ignored) -> NHWC float32."""

    def __init__(self, in_channels: int = 2, resolution: Sequence[int] = (64, 1024), base_channels: int = 128,
                 channel_multiplier: Sequence[int] = (1, 2, 2, 2)):
        super().__init__()
        self.resolution = tuple(resolution)
        self.register_buffer("coords", torch.zeros(1, 2, *self.resolution))
        C = [base_channels] + [base_channels * m for m in channel_multiplier]
        self.in_conv = Conv(in_channels + 2, C[0], circular=False)
        self.d_block1 = nn.Sequential(ResBlock(C[0], C[1]), ResBlock(C[1], C[1]))
        self.d_block2 = nn.Sequential(ResBlock(C[1], C[2], "down"), ResBlock(C[2], C[2]))
        self.d_block3 = nn.Sequential(ResBlock(C[2], C[3], "down", 2), ResBlock(C[3], C[3], dilation=2))
        self.d_block4 = nn.Sequential(ResBlock(C[3], C[4], "down", 4), ResBlock(C[4], C[4], dilation=4))
        self.u_block4 = RefineBlock([C[4]], C[3])
        self.u_block3 = RefineBlock([C[3], C[3]], C[2])
        self.u_block2 = RefineBlock([C[2], C[2]], C[1])
        self.u_block1 = RefineBlock([C[1], C[1]], C[0], end_blocks=3)
        self.out_conv = nn.Sequential(InstanceNormPlus(C[0]), nn.ELU(), Conv(C[0], in_channels, circular=False))

    def set_quant(self, quant: Optional[str]) -> "RefineNet":
        for m in self.modules():
            if hasattr(m, "quant"):
                m.quant = quant
        return self

    def forward(self, x: torch.Tensor, condition: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).float()
        h = self.in_conv(torch.cat([x, self.coords.expand(x.shape[0], -1, -1, -1)], dim=1))
        h1 = self.d_block1(h)
        h2 = self.d_block2(h1)
        h3 = self.d_block3(h2)
        h4 = self.d_block4(h3)
        u = self.u_block4([h4], h4.shape[2:])
        u = self.u_block3([h3, u], h3.shape[2:])
        u = self.u_block2([h2, u], h2.shape[2:])
        u = self.u_block1([h1, u], h1.shape[2:])
        return self.out_conv(u).permute(0, 2, 3, 1)
