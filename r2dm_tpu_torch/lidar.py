"""LiDAR range image <-> physical space (``r2dm_tpu/lidar.py``, reference
``utils/lidar.py:23-120``): metric depth <-> normalized [0, 1] images
(log2 / inverse / linear), [0, 1] <-> [-1, 1], back-projection to XYZ through
per-pixel ray angles, and the min/max depth mask. ``data_format`` picks
NHWC or NCHW for every method; the hub surface uses NCHW.
"""

from __future__ import annotations

import math
import numpy as np
import torch

from .ops.encoding import get_hdl64e_linear_ray_angles


def nearest_exact_resize_hw(x: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Nearest-exact resize of (H, W, C): index = floor((i + 0.5) * in/out),
    as torch F.interpolate(mode="nearest-exact")."""
    H, W = x.shape[:2]
    out_h, out_w = size
    rows = np.clip(np.floor((np.arange(out_h) + 0.5) * H / out_h), 0, H - 1)
    cols = np.clip(np.floor((np.arange(out_w) + 0.5) * W / out_w), 0, W - 1)
    return x[rows.astype(np.int64)][:, cols.astype(np.int64)]


class LiDARUtility:
    def __init__(
        self,
        resolution: tuple[int, int],
        depth_format: str,
        min_depth: float,
        max_depth: float,
        ray_angles=None,
        data_format: str = "NHWC",
        device=None,
    ):
        if depth_format not in ("log_depth", "inverse_depth", "depth"):
            raise ValueError(f"unknown depth_format {depth_format!r}")
        if data_format not in ("NHWC", "NCHW"):
            raise ValueError(f"data_format must be NHWC or NCHW, got {data_format!r}")
        self.resolution = tuple(resolution)
        self.depth_format = depth_format
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)
        self.data_format = data_format
        if ray_angles is None:
            angles = get_hdl64e_linear_ray_angles(*resolution)
        else:
            if isinstance(ray_angles, torch.Tensor):
                ray_angles = ray_angles.detach().cpu().numpy()
            angles = np.asarray(ray_angles, dtype=np.float32)
            if angles.ndim == 4 and angles.shape[:2] == (1, 2):  # reference layout
                angles = np.transpose(angles[0], (1, 2, 0))
            if angles.ndim != 3 or angles.shape[-1] != 2:
                raise ValueError(f"ray_angles must be (H, W, 2) or (1, 2, H, W), got {angles.shape}")
        angles = nearest_exact_resize_hw(angles, self.resolution)
        self.ray_angles = torch.as_tensor(np.ascontiguousarray(angles), dtype=torch.float32, device=device)

    def _angles_for(self, x: torch.Tensor):
        phi = self.ray_angles[..., 0].to(x.device)
        theta = self.ray_angles[..., 1].to(x.device)
        if self.data_format == "NHWC":
            return phi[None, :, :, None], theta[None, :, :, None]
        return phi[None, None], theta[None, None]

    @staticmethod
    def denormalize(x: torch.Tensor) -> torch.Tensor:
        """[-1, 1] -> [0, 1]."""
        return (x + 1.0) / 2.0

    @staticmethod
    def normalize(x: torch.Tensor) -> torch.Tensor:
        """[0, 1] -> [-1, 1]."""
        return x * 2.0 - 1.0

    def get_mask(self, metric: torch.Tensor) -> torch.Tensor:
        """1.0 where min_depth < depth < max_depth."""
        return ((metric > self.min_depth) & (metric < self.max_depth)).to(torch.float32)

    def convert_depth(self, metric: torch.Tensor) -> torch.Tensor:
        """Metric depth -> normalized [0, 1], invalid depths zeroed."""
        if self.depth_format == "log_depth":
            normalized = torch.log2(metric + 1.0) / math.log2(self.max_depth + 1.0)
        elif self.depth_format == "inverse_depth":
            normalized = self.min_depth / (metric + 1e-8)
        else:
            normalized = metric / self.max_depth
        return torch.clamp(normalized, 0.0, 1.0) * self.get_mask(metric)

    def revert_depth(self, normalized: torch.Tensor) -> torch.Tensor:
        """Normalized [0, 1] -> metric depth, invalid depths zeroed."""
        if self.depth_format == "log_depth":
            metric = torch.exp2(normalized * math.log2(self.max_depth + 1.0)) - 1.0
        elif self.depth_format == "inverse_depth":
            metric = self.min_depth / (normalized + 1e-8)
        else:
            metric = normalized * self.max_depth
        return metric * self.get_mask(metric)

    def to_xyz(self, metric: torch.Tensor) -> torch.Tensor:
        """Back-project metric depth through the ray angles, invalid depths
        zeroed. NHWC (B, H, W, 1) -> (B, H, W, 3); NCHW (B, 1, H, W) ->
        (B, 3, H, W)."""
        assert metric.dim() == 4
        mask = self.get_mask(metric)
        phi, theta = self._angles_for(metric)
        x = metric * torch.cos(phi) * torch.cos(theta)
        y = metric * torch.cos(phi) * torch.sin(theta)
        z = metric * torch.sin(phi)
        dim = -1 if self.data_format == "NHWC" else 1
        return torch.cat([x, y, z], dim=dim) * mask
