"""Efficient U-Net denoiser (NHWC), the config-H network of R2DM.

Same network as ``r2dm_tpu/models/efficient_unet.py`` (reference
``models/efficient_unet.py:188-295``): ring padding everywhere, AdaGN time
conditioning, self-attention only at the bottleneck, concat skips, zero-init
output conv, 1/sqrt(2) residual scaling, and a coordinate encoding
concatenated to the input. Module names follow the reference, so its
``state_dict`` loads as it is. The down path is conv then FIR downsample,
the up path FIR upsample then conv; as in the JAX package, each side listed
in ``models.layers.FUSED_RESAMPLE`` (default "down") runs as one composed
conv (``ops/fused_resample.py``), with the same parameters. The output is
always fp32. ``dropout`` acts in the ResidualBlocks in training mode only,
its masks drawn from the ``generator`` given to forward. An inference
forward on a card at up to ``forward_graph.MAX_GRAPH_PIXELS`` pixels
replays a CUDA graph of itself (``models/forward_graph.py``): the same
kernels, launched by one call.

Under a width axis (``layers.set_width_shard``) the network takes and
returns its rank's columns of each image, and its coordinate encoding is
those columns of the whole image's (the encoding is per pixel, so slicing
after encoding is exact). The narrowest level, W/8, must split over the
width axis with at least 3 columns a rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops import encoding as enc
from ..ops.resample import downsample2x, fir_kernel, upsample2x
from ..parallel.width import shard_columns
from ..utils import trace
from . import forward_graph, layers
from .layers import Dense, ResidualBlock, RingConv, SelfAttentionBlock


class SinusoidalEmbedding(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return enc.timestep_embedding(t, self.channels)


class TimeEmbedding(nn.Sequential):
    """Sinusoidal embedding -> Linear -> SiLU -> Linear (reference
    models/efficient_unet.py:232-237): ``time_embedding.{1,3}``."""

    def __init__(self, base_channels: int, temb_channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__(
            SinusoidalEmbedding(base_channels),
            Dense(base_channels, temb_channels, dtype=dtype),
            nn.SiLU(),
            Dense(temb_channels, temb_channels, dtype=dtype),
        )


class Resample(nn.Module):
    """2x FIR upsample (``up``) or downsample with ring margins."""

    def __init__(self, up: bool):
        super().__init__()
        self.up = up
        # kept on the module's device: a filter built per call would be
        # copied from the host, which blocks the host until the card is idle
        self.register_buffer("fir", fir_kernel(up=2 if up else 1), persistent=False)
        self.width_shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up:
            return upsample2x(x, self.fir, width=self.width_shard)
        return downsample2x(x, self.fir, width=self.width_shard)


class UNetBlock(nn.Module):
    """One U-Net level: [down] -> resblocks -> [attn] -> [up] (reference
    Block, models/efficient_unet.py:113-185)."""

    def __init__(
        self, in_channels: int, out_channels: int, num_residual_blocks: int,
        emb_channels: int, gn_num_groups: int = 8, gn_eps: float = 1e-6,
        attn: bool = False, attn_num_heads: int = 8, up: bool = False, down: bool = False,
        dtype: Optional[torch.dtype] = None, dropout: float = 0.0,
    ):
        super().__init__()
        self.downsample = None
        if down:
            # the JAX package composes the down conv with the FIR filter,
            # so the int8 lane leaves it in the compute dtype
            self.downsample = nn.Sequential(
                RingConv(in_channels, out_channels, dtype=dtype, quantizable=False), Resample(up=False)
            )
            in_channels = out_channels
        self.residual_blocks = nn.ModuleList(
            ResidualBlock(
                in_channels if i == 0 else out_channels, out_channels, emb_channels,
                gn_num_groups, gn_eps, dtype=dtype, dropout=dropout,
            )
            for i in range(num_residual_blocks)
        )
        self.self_attn_block = (
            SelfAttentionBlock(out_channels, attn_num_heads, gn_num_groups, gn_eps, dtype=dtype)
            if attn else None
        )
        self.upsample = None
        if up:
            self.upsample = nn.Sequential(
                Resample(up=True), RingConv(out_channels, out_channels, dtype=dtype)
            )

    def down(self, h: torch.Tensor) -> torch.Tensor:
        """The down conv and the FIR downsample: one composed conv when
        ``layers.FUSED_RESAMPLE`` lists "down" (JAX efficient_unet.py:108-120)."""
        if layers.FUSED_RESAMPLE in layers.FUSED_DOWN:
            return self.downsample[0].conv_then_downsample(h)
        return self.downsample(h)

    def up(self, h: torch.Tensor) -> torch.Tensor:
        """The FIR upsample and the up conv, composed when
        ``layers.FUSED_RESAMPLE`` lists "up" (JAX efficient_unet.py:147-158)."""
        if layers.FUSED_RESAMPLE in layers.FUSED_UP:
            return self.upsample[1].upsample_then_conv(h)
        return self.upsample(h)

    def forward(self, h: torch.Tensor, temb: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.downsample is not None:
            h = self.down(h)
        for block in self.residual_blocks:
            h = block(h, temb, generator)
        if self.self_attn_block is not None:
            h = self.self_attn_block(h)
        if self.upsample is not None:
            h = self.up(h)
        return h


class EfficientUNet(nn.Module):
    """forward(images NHWC (B, H, W, in_channels), timesteps (B,)) -> NHWC fp32.

    ``width_merge_l1`` is the JAX package's W2C latency layout
    (``r2dm_tpu/ops/w2c.py``): level 1 on width-pair-merged (B, H, W/2, 2C)
    tensors, with the same parameters and the same math. The aligned merge
    is a reshape of contiguous NHWC memory, so on this card the merged
    tensor is the same bytes as the NHWC one; with the flag on the port
    runs level 1 on the NHWC kernels, the same hand-written GroupNorm and
    ring-conv kernels as with it off, and the flag changes no output. It is
    kept as ``self.width_merge_l1``, as JAX keeps its module field, so a
    caller can see which layout was asked for; no computation reads it."""

    architecture = "efficient_unet"

    def __init__(
        self,
        in_channels: int = 2,
        resolution: tuple[int, int] = (64, 1024),
        out_channels: Optional[int] = None,
        base_channels: int = 64,
        temb_channels: Optional[int] = None,
        channel_multiplier: Sequence[int] = (1, 2, 4, 8),
        num_residual_blocks: Sequence[int] = (3, 3, 3, 3),
        gn_num_groups: int = 8,
        gn_eps: float = 1e-6,
        attn_num_heads: int = 8,
        coords_encoding: Optional[str] = "fourier_features",
        dtype: Optional[torch.dtype] = None,
        dropout: float = 0.0,
        width_merge_l1: bool = False,
    ):
        super().__init__()
        self.width_merge_l1 = width_merge_l1
        self.width_shard = None
        self._graphs = forward_graph.ForwardGraphs()
        if coords_encoding not in (None, "spherical_harmonics", "polar_coordinates", "fourier_features"):
            raise ValueError(f"unknown coords_encoding: {coords_encoding}")
        self.in_channels = in_channels
        self.resolution = tuple(resolution)
        self.coords_encoding = coords_encoding
        temb = base_channels * 4 if temb_channels is None else temb_channels
        self.time_embedding = TimeEmbedding(base_channels, temb, dtype=dtype)
        # (1, 2, H, W) coordinate buffer in the reference layout; the polar
        # grid by default, the sensor's ray angles once a checkpoint loads
        coords = enc.generate_polar_coords(*self.resolution)
        self.register_buffer("coords", torch.from_numpy(np.ascontiguousarray(coords.transpose(2, 0, 1)[None])))
        freqs = enc.fourier_feature_frequencies(self.resolution)
        self.register_buffer("ff_freqs", torch.from_numpy(freqs), persistent=False)

        C = [base_channels] + [base_channels * m for m in channel_multiplier]
        N = tuple(num_residual_blocks)
        cfg = dict(
            emb_channels=temb, gn_num_groups=gn_num_groups, gn_eps=gn_eps,
            attn_num_heads=attn_num_heads, dtype=dtype, dropout=dropout,
        )
        self.in_conv = RingConv(in_channels + self.coords_channels(), C[0], dtype=dtype)
        self.d_block1 = UNetBlock(C[0], C[1], N[0], **cfg)
        self.d_block2 = UNetBlock(C[1], C[2], N[1], down=True, **cfg)
        self.d_block3 = UNetBlock(C[2], C[3], N[2], down=True, **cfg)
        self.d_block4 = UNetBlock(C[3], C[4], N[3], down=True, attn=True, **cfg)
        self.u_block4 = UNetBlock(C[4], C[3], N[3], up=True, attn=True, **cfg)
        self.u_block3 = UNetBlock(C[3] * 2, C[2], N[2], up=True, **cfg)
        self.u_block2 = UNetBlock(C[2] * 2, C[1], N[1], up=True, **cfg)
        self.u_block1 = UNetBlock(C[1] * 2, C[0], N[0], **cfg)
        out_ch = in_channels if out_channels is None else out_channels
        self.out_conv = RingConv(C[0], out_ch, dtype=dtype)
        nn.init.zeros_(self.out_conv.weight)

    def coords_channels(self) -> int:
        if self.coords_encoding == "spherical_harmonics":
            return 25
        if self.coords_encoding == "polar_coordinates":
            return 2
        if self.coords_encoding == "fourier_features":
            return enc.fourier_features_channels(self.resolution)
        return 0

    # columns a rank needs at the narrowest level: the composed down conv
    # reads x[2o - 2 .. 2o + 3], and the FIR up path's margin is 2
    MIN_WIDTH_COLUMNS = 3

    def check_width_shard(self, width_size: int) -> None:
        """Raise unless every level's W splits over ``width_size`` ranks with
        at least ``MIN_WIDTH_COLUMNS`` columns a rank at the narrowest."""
        W = self.resolution[1]
        narrow = W // 8
        if W % 8 or narrow % width_size or narrow // width_size < self.MIN_WIDTH_COLUMNS:
            raise ValueError(
                f"a {width_size}-way width axis does not split level 4 (W = {narrow} at {self.resolution[0]}x{W}): "
                f"it needs W/8 divisible by the width axis with at least {self.MIN_WIDTH_COLUMNS} columns a rank")

    def _coords_encoding(self) -> Optional[torch.Tensor]:
        coords = self.coords[0].permute(1, 2, 0)  # (H, W, 2)
        if self.coords_encoding == "spherical_harmonics":
            encoded = enc.spherical_harmonics(coords, levels=5)
        elif self.coords_encoding == "polar_coordinates":
            encoded = coords
        elif self.coords_encoding == "fourier_features":
            encoded = enc.fourier_features(coords, self.ff_freqs)
        else:
            return None
        return encoded if self.width_shard is None else shard_columns(encoded, self.width_shard, dim=1)

    def forward(
        self, images: torch.Tensor, timesteps: torch.Tensor, generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The forward, replayed as a CUDA graph (``forward_graph``) unless
        ``forward_graph.eager_reason`` names a reason to run it eagerly."""
        with trace.span("network.forward"):
            trace.count("network.forwards")
            if self._graphs.eager_reason(self, images, generator) is None:
                return self._graphs(self, images, timesteps)
            return self._forward(images, timesteps, generator)

    def _forward(
        self, images: torch.Tensor, timesteps: torch.Tensor, generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        B = images.shape[0]
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(B)
        temb = self.time_embedding(timesteps)
        h = images
        cenc = self._coords_encoding()
        if cenc is not None:
            cenc = cenc[None].expand(B, *cenc.shape).to(h.dtype)
            h = torch.cat([h, cenc], dim=-1)
        h = self.in_conv(h)
        h1 = self.d_block1(h, temb, generator)
        h2 = self.d_block2(h1, temb, generator)
        h3 = self.d_block3(h2, temb, generator)
        h4 = self.d_block4(h3, temb, generator)
        h = self.u_block4(h4, temb, generator)
        h = self.u_block3(torch.cat([h, h3], dim=-1), temb, generator)
        h = self.u_block2(torch.cat([h, h2], dim=-1), temb, generator)
        h = self.u_block1(torch.cat([h, h1], dim=-1), temb, generator)
        return self.out_conv(h).to(torch.float32)
