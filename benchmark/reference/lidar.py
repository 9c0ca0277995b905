"""R2DM's range-image conversions in plain float32 (kazuto1011/r2dm
``utils/lidar.py``, ``train.py`` preprocess, ``sample_and_save.py``
postprocess), log-depth format, KITTI's depth range [1.45, 80] m.

- preprocess: metric depth -> log2(d + 1) / log2(81), clipped to [0, 1] and
  zeroed outside (1.45, 80); concatenated with the reflectance; mapped
  [0, 1] -> [-1, 1]. NHWC (B, H, W, 1) planes in, (B, H, W, 2) out.
- postprocess: a sample in [-1, 1] (NCHW, clamped) -> [0, 1] -> metric depth
  2^(x log2 81) - 1 (zeroed outside the range), the points
  (d cos(el) cos(az), d cos(el) sin(az), d sin(el)) through the ray angles,
  and the reflectance: (B, 5, H, W) [depth, x, y, z, reflectance].
"""

from __future__ import annotations

import math

import torch

MIN_DEPTH, MAX_DEPTH = 1.45, 80.0


def _mask(d: torch.Tensor) -> torch.Tensor:
    return ((d > MIN_DEPTH) & (d < MAX_DEPTH)).float()


def preprocess(depth: torch.Tensor, reflectance: torch.Tensor) -> torch.Tensor:
    norm = torch.clamp(torch.log2(depth + 1.0) / math.log2(MAX_DEPTH + 1.0), 0.0, 1.0) * _mask(depth)
    return torch.cat([norm, reflectance], dim=-1) * 2.0 - 1.0


def postprocess(x: torch.Tensor, angles: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``angles``: (1, 2, H, W) elevation and azimuth in radians; computed in
    ``dtype`` (float32 unless the check's control asks for less), float32 out."""
    x, angles = x.to(dtype), angles.to(dtype)
    x = (torch.clamp(x, -1.0, 1.0) + 1.0) / 2.0
    depth = torch.exp2(x[:, 0:1] * math.log2(MAX_DEPTH + 1.0)) - 1.0
    depth = depth * _mask(depth)
    el, az = angles[:, 0:1], angles[:, 1:2]
    xyz = torch.cat([depth * torch.cos(el) * torch.cos(az), depth * torch.cos(el) * torch.sin(az),
                     depth * torch.sin(el)], dim=1) * _mask(depth)
    return torch.cat([depth, xyz, x[:, 1:2]], dim=1).float()
