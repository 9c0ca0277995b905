"""The LiDARGen RefineNet denoiser (NCSN-style), the port of
``r2dm_tpu/models/refinenet.py`` (reference ``models/refinenet.py:16-233``).

Circular convolutions (both H and W wrap, unlike the EfficientUNet's ring),
InstanceNorm2d+ with fp32 statistics, dilated residual blocks (levels 3 and
4 dilate by 2 and 4 instead of downsampling), a RefineNet decoder of
residual conv units and chained residual pooling, and bilinear
align_corners=True fusion as two interpolation matmuls. The timesteps are
accepted and ignored: the reference LiDARGen baseline conditions on nothing.

``forward(images NHWC, timesteps, generator=None) -> NHWC fp32``, the call
of the port's ``EfficientUNet``, so every sampler and the trainer drive
either network; ``generator`` is accepted for that uniformity (RefineNet has
no dropout). Inside, the tensors are NCHW views of the NHWC input (channels-
last in memory, which cuDNN convolves as it is). Parameters carry the
reference torch ``state_dict`` names (``d_block2.0.conv2.0.weight``,
``u_block3.adaptive_convs.1.0.units.0.3.weight``, ``out_conv.0.alpha``, ...)
and stay fp32; with ``dtype`` the convolutions and the interpolation compute
in it, the norms in fp32 (the JAX module's policy). Every operation is plain
PyTorch: the JAX package has no Pallas kernel behind this network.

Under a width axis (``layers.set_width_shard``; the JAX package's GSPMD
sharding of W) the network takes and returns its rank's columns of each
image, and computes on them what one rank computes on the whole image: the
convs take W's margins from the neighbours' columns (``parallel/width.py::
pad_columns``; the ring wraps across ranks, and the two zero-padded convs
see zeros only past the image's outer columns), InstanceNorm++ sums its
statistics over the width group (``sum_over_width``, differentiable), the
max pools take 2 columns of each neighbour (-inf past the outer columns),
the upsample one column of each neighbour inside the image and its rank's
rows of the interpolation matrix, and ``coords`` is cut to the rank's
columns. H stays whole on every rank. The average pools are local, since
every rank's columns start at an even offset (``check_width_shard``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.width import halo_exchange, pad_columns, shard_columns, sharded, sum_over_width
from ..utils import trace
from .layers import _compute_dtype

NORM_EPS = 1e-5


def pad_hw(x: torch.Tensor, p: int, circular: bool, width=None) -> torch.Tensor:
    """NCHW ``x`` padded by ``p`` on every side, circularly (both axes wrap,
    torch's padding_mode='circular') or with zeros. Under a width axis
    (``width``) W's margins are the neighbours' columns, zeros past the
    image's outer columns when not circular."""
    mode = "circular" if circular else "constant"
    if not sharded(width):
        return F.pad(x, (p,) * 4, mode=mode)
    x = pad_columns(x, p, p, width, dim=3, edge=None if circular else 0.0)
    return F.pad(x, (0, 0, p, p), mode=mode)


class Conv(nn.Conv2d):
    """A conv with the flax ``nn.Conv(dtype=...)`` casting policy, padded by
    ``padding`` in both axes (``pad_hw``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, padding: int = 1,
                 dilation: int = 1, bias: bool = True, circular: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size, dilation=dilation, bias=bias)
        self.pad = padding
        self.circular = circular
        self.compute_dtype = dtype
        self.width_shard = None  # set_width_shard: the World whose width group splits W

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = _compute_dtype(self.compute_dtype, x, self.weight)
        x = x.to(cd)
        if self.pad:
            x = pad_hw(x, self.pad, self.circular, self.width_shard)
        bias = self.bias.to(cd) if self.bias is not None else None
        return F.conv2d(x, self.weight.to(cd), bias, dilation=self.dilation)


class PostAffine(nn.Module):
    """The per-channel affine of InstanceNorm2d+, stored as the reference's
    depthwise 1x1 conv (weight (C, 1, 1, 1), bias (C,))."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(1.0 + 0.02 * torch.randn(channels, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(channels))


class InstanceNormPlus(nn.Module):
    """InstanceNorm2d+ (NCSNv2; refinenet.py:57-86): the non-affine instance
    norm, scaled by the per-channel means standardised over the channels
    (unbiased variance), then a per-channel affine; the statistics in fp32
    (fp64 for an fp64 x), the result in x's dtype. The variance is
    two-pass, the mean of (x - mean)^2, as in JAX. Under a width axis each
    sum over H x W is the rank's, accumulated in fp64, summed over the group
    and rounded to fp32 once, so the statistics hardly depend on how the
    columns are split."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(1.0 + 0.02 * torch.randn(1, channels, 1, 1))
        self.post_affine = PostAffine(channels)
        self.width_shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        w = self.width_shard
        if sharded(w):
            n = xf.shape[2] * xf.shape[3] * w.width_size

            def mean_hw_of(t):
                return (sum_over_width(t.sum(dim=(2, 3), keepdim=True, dtype=torch.float64), w) / n).to(xf.dtype)

            mean_hw = mean_hw_of(xf)  # (B, C, 1, 1)
            var_hw = mean_hw_of((xf - mean_hw).square())
        else:  # torch's fp32 reductions, as close to the flax module's as the fp32 parity tests need
            mean_hw = xf.mean(dim=(2, 3), keepdim=True)
            var_hw = xf.var(dim=(2, 3), keepdim=True, correction=0)
        m = mean_hw.mean(dim=1, keepdim=True)
        v = mean_hw.var(dim=1, keepdim=True, correction=1)
        mean_n = (mean_hw - m) / torch.sqrt(v + NORM_EPS)
        inst = (xf - mean_hw) * torch.rsqrt(var_hw + NORM_EPS)
        h = inst * self.alpha * mean_n
        h = h * self.post_affine.weight.view(1, -1, 1, 1) + self.post_affine.bias.view(1, -1, 1, 1)
        return h.to(x.dtype)


class MaxPool5(nn.Module):
    """MaxPool2d(5, 1, 2): -inf padding, stride 1 (refinenet.py:89-102).
    Under a width axis W's margins are 2 columns of each neighbour, -inf
    past the image's outer columns (the pool does not wrap)."""

    def __init__(self):
        super().__init__()
        self.width_shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not sharded(self.width_shard):
            return F.max_pool2d(x, 5, 1, 2)
        return F.max_pool2d(pad_columns(x, 2, 2, self.width_shard, dim=3, edge=-math.inf), 5, 1, (2, 0))


def interp_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) fp32 weights of align_corners=True linear
    interpolation, built on the host as the JAX function builds them (a
    size-1 axis selects index 0)."""
    m = torch.zeros((n_out, n_in), dtype=torch.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m
    src = torch.arange(n_out, dtype=torch.float32) * (n_in - 1) / (n_out - 1)
    lo = torch.clamp(torch.floor(src).to(torch.int64), 0, n_in - 1)
    hi = torch.clamp(lo + 1, 0, n_in - 1)
    w_hi = src - lo
    rows = torch.arange(n_out)
    m.index_put_((rows, lo), 1.0 - w_hi, accumulate=True)
    m.index_put_((rows, hi), w_hi, accumulate=True)
    return m


def rank_interp_matrix(n_in: int, n_out: int, rank: int, ranks: int) -> torch.Tensor:
    """Width rank ``rank``'s rows of ``interp_matrix(n_in, n_out)`` (its
    output columns), on its input columns and one of each neighbour that
    lies inside the image (the interpolation does not wrap); the whole
    matrix for one rank. With align_corners a rank's outputs read no column
    beyond those, whatever the two sizes
    (tests/test_torch_port_refinenet_width.py)."""
    m = interp_matrix(n_in, n_out)[rank * (n_out // ranks):(rank + 1) * (n_out // ranks)]
    return m[:, max(rank * (n_in // ranks) - 1, 0):min((rank + 1) * (n_in // ranks) + 1, n_in)]


class BilinearAlignCorners(nn.Module):
    """F.interpolate(mode='bilinear', align_corners=True) of NCHW x as two
    interpolation matmuls in x's dtype (refinenet.py:105-130); the matrices
    are kept per (size, width rank, dtype, device), so none is copied from
    the host inside a forward after the first. Under a width axis ``size``
    is the rank's, and x takes one column of each neighbour inside the
    image (``rank_interp_matrix``)."""

    def __init__(self):
        super().__init__()
        self._mats: dict = {}
        self.width_shard = None

    def matrix(self, n_in: int, n_out: int, like: torch.Tensor, rank: int = 0, ranks: int = 1) -> torch.Tensor:
        key = (n_in, n_out, rank, ranks, like.dtype, like.device)
        if key not in self._mats:
            self._mats[key] = rank_interp_matrix(n_in, n_out, rank, ranks).to(device=like.device, dtype=like.dtype)
        return self._mats[key]

    def forward(self, x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
        H, W = x.shape[2:]
        if (H, W) == tuple(size):
            return x
        w = self.width_shard
        rank, ranks = (w.width_rank, w.width_size) if sharded(w) else (0, 1)
        if ranks > 1:
            lft, rgt = halo_exchange(x, 1, 1, w, dim=3)
            x = torch.cat(([lft] if rank > 0 else []) + [x] + ([rgt] if rank < ranks - 1 else []), dim=3)
        x = torch.einsum("oh,bchw->bcow", self.matrix(H, size[0], x), x)
        return torch.einsum("ow,bchw->bcho", self.matrix(W * ranks, size[1] * ranks, x, rank, ranks), x)


class RNResidualBlock(nn.Module):
    """norm-ELU-conv x2, with dilation or an average-pool downsample
    (refinenet.py:43-94; reference keys ``conv2.0``/``skip.0`` where the
    conv is followed by the pool)."""

    def __init__(self, in_channels: int, out_channels: int, resample: Optional[str] = None, dilation: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        mid = in_channels if resample == "down" else out_channels
        kw = dict(padding=dilation, dilation=dilation, dtype=dtype)
        self.pool = dilation == 1 and resample is not None
        self.norm1 = InstanceNormPlus(in_channels)
        self.conv1 = Conv(in_channels, mid, **kw)
        self.norm2 = InstanceNormPlus(mid)
        conv2 = Conv(mid, out_channels, **kw)
        self.conv2 = nn.Sequential(conv2, nn.AvgPool2d(2)) if self.pool else conv2
        self.skip = None
        if in_channels != out_channels or resample is not None:
            skip = (Conv(in_channels, out_channels, 1, padding=0, dtype=dtype) if dilation == 1
                    else Conv(in_channels, out_channels, **kw))
            self.skip = nn.Sequential(skip, nn.AvgPool2d(2)) if self.pool else skip

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.elu(self.norm1(x)))
        h = self.conv2(F.elu(self.norm2(h)))
        skip = self.skip(x) if self.skip is not None else x
        return skip + h


def _rcu_stage(channels: int, dtype) -> list:
    return [nn.ELU(), Conv(channels, channels, bias=False, dtype=dtype)]


class ResidualConvUnit(nn.Module):
    """``num_blocks`` x (x + conv(elu(conv(elu(x))))) (refinenet.py:97-111);
    ``units.j`` is Sequential(ELU, conv, ELU, conv)."""

    def __init__(self, channels: int, num_blocks: int = 2, num_stages: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.units = nn.ModuleList(
            nn.Sequential(*[m for _ in range(num_stages) for m in _rcu_stage(channels, dtype)])
            for _ in range(num_blocks)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for unit in self.units:
            x = x + unit(x)
        return x


class ChainedResidualPooling(nn.Module):
    """h = elu(x); then per stage h = h + conv(maxpool5(h)) (refinenet.py:
    114-130); ``convs.i`` is Sequential(MaxPool2d, conv)."""

    def __init__(self, channels: int, num_stages: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Sequential(MaxPool5(), Conv(channels, channels, bias=False, dtype=dtype))
            for _ in range(num_stages)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.elu(x)
        for conv in self.convs:
            h = h + conv(h)
        return h


class RefineBlock(nn.Module):
    """Multi-resolution fusion, chained residual pooling and the output RCUs
    (refinenet.py:133-154): each input through its RCU (``adaptive_convs.i.0``)
    and, with more than one input, a conv to ``out_channels``
    (``adaptive_convs.i.1``), upsampled to ``shape`` and summed."""

    def __init__(self, in_channels: Sequence[int], out_channels: int, num_end_blocks: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        multi = len(in_channels) > 1
        self.adaptive_convs = nn.ModuleList(
            nn.Sequential(ResidualConvUnit(c, dtype=dtype), *([Conv(c, out_channels, dtype=dtype)] if multi else []))
            for c in in_channels
        )
        self.upsample = BilinearAlignCorners()
        self.crp = ChainedResidualPooling(out_channels, dtype=dtype)
        self.output_conv = ResidualConvUnit(out_channels, num_blocks=num_end_blocks, dtype=dtype)

    def forward(self, xs: Sequence[torch.Tensor], shape: tuple[int, int]) -> torch.Tensor:
        h = None
        for adapt, x in zip(self.adaptive_convs, xs):
            y = self.upsample(adapt(x), shape)
            h = y if h is None else h + y
        return self.output_conv(self.crp(h))


def unit_grid(resolution: tuple[int, int]) -> np.ndarray:
    """(1, 2, H, W) fp32: the [0, 1]-normalised (row, column) grid of the
    network's ``coords`` buffer (refinenet.py:175-181)."""
    rows, cols = np.meshgrid(np.linspace(0, 1, resolution[0], dtype=np.float32),
                             np.linspace(0, 1, resolution[1], dtype=np.float32), indexing="ij")
    return np.stack([rows, cols])[None]


class LiDARGenRefineNet(nn.Module):
    """forward(images NHWC (B, H, W, in_channels), timesteps, generator=None)
    -> NHWC fp32; the timesteps and the generator are ignored."""

    # columns a rank needs at half width: the dilation-4 convs' halo
    MIN_WIDTH_COLUMNS = 4

    architecture = "refinenet"

    def __init__(
        self,
        in_channels: int = 2,
        resolution: tuple[int, int] = (64, 1024),
        out_channels: Optional[int] = None,
        base_channels: int = 128,
        channel_multiplier: Sequence[int] = (1, 2, 2, 2),
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.resolution = tuple(resolution)
        self.register_buffer("coords", torch.from_numpy(unit_grid(self.resolution)))
        C = [base_channels] + [base_channels * m for m in channel_multiplier]
        kw = dict(dtype=dtype)
        self.in_conv = Conv(in_channels + 2, C[0], circular=False, **kw)  # a plain nn.Conv2d there (:187)
        self.d_block1 = nn.Sequential(RNResidualBlock(C[0], C[1], **kw), RNResidualBlock(C[1], C[1], **kw))
        self.d_block2 = nn.Sequential(RNResidualBlock(C[1], C[2], "down", **kw), RNResidualBlock(C[2], C[2], **kw))
        self.d_block3 = nn.Sequential(RNResidualBlock(C[2], C[3], "down", 2, **kw),
                                      RNResidualBlock(C[3], C[3], dilation=2, **kw))
        self.d_block4 = nn.Sequential(RNResidualBlock(C[3], C[4], "down", 4, **kw),
                                      RNResidualBlock(C[4], C[4], dilation=4, **kw))
        self.u_block4 = RefineBlock([C[4]], C[3], **kw)
        self.u_block3 = RefineBlock([C[3], C[3]], C[2], **kw)
        self.u_block2 = RefineBlock([C[2], C[2]], C[1], **kw)
        self.u_block1 = RefineBlock([C[1], C[1]], C[0], num_end_blocks=3, **kw)
        out_ch = in_channels if out_channels is None else out_channels
        self.out_conv = nn.Sequential(InstanceNormPlus(C[0]), nn.ELU(), Conv(C[0], out_ch, circular=False, **kw))
        self.width_shard = None

    def check_width_shard(self, width_size: int) -> None:
        """Raise unless W splits over ``width_size`` ranks into an even
        number of columns a rank (the average pool to level 2 stays local)
        with at least ``MIN_WIDTH_COLUMNS`` a rank at half width."""
        H, W = self.resolution
        if W % (2 * width_size):
            raise ValueError(
                f"a {width_size}-way width axis does not split level 1 (W = {W} at {H}x{W}) into an even number "
                "of columns a rank (the average pool to level 2)")
        if W // (2 * width_size) < self.MIN_WIDTH_COLUMNS:
            raise ValueError(
                f"a {width_size}-way width axis leaves level 2 (W = {W // 2} at {H // 2}x{W // 2}) "
                f"{W // (2 * width_size)} columns a rank; it needs at least {self.MIN_WIDTH_COLUMNS} "
                "(the dilation-4 convs' halo)")

    def forward(self, images: torch.Tensor, timesteps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with trace.span("network.forward"):
            x = images.permute(0, 3, 1, 2)
            coords = shard_columns(self.coords, self.width_shard, dim=3).expand(x.shape[0], -1, -1, -1).to(x.dtype)
            h = self.in_conv(torch.cat([x, coords], dim=1))
            h1 = self.d_block1(h)
            h2 = self.d_block2(h1)
            h3 = self.d_block3(h2)
            h4 = self.d_block4(h3)
            u = self.u_block4([h4], h4.shape[2:])
            u = self.u_block3([h3, u], h3.shape[2:])
            u = self.u_block2([h2, u], h2.shape[2:])
            u = self.u_block1([h1, u], h1.shape[2:])
            return self.out_conv(u).permute(0, 2, 3, 1).to(torch.float32).contiguous()
