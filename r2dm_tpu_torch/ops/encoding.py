"""Spatial coordinate encodings and the timestep embedding.

Same functions as ``r2dm_tpu/ops/encoding.py`` (reference
``models/encoding.py:10-149``, ``models/ops.py:14-29``). Angle grids are
(H, W, 2) holding (phi/elevation, theta/azimuth) per pixel; the grid makers
return numpy, the encodings take and return torch tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def generate_polar_coords(H: int, W: int) -> np.ndarray:
    """(H, W, 2) grid of (phi in [-pi/2, pi/2], theta in [-pi, pi])."""
    phi = (0.5 - np.arange(H) / H) * np.pi
    theta = (1 - np.arange(W) / W) * 2 * np.pi - np.pi
    phi, theta = np.meshgrid(phi, theta, indexing="ij")
    return np.stack([phi, theta], axis=-1).astype(np.float32)


def get_hdl64e_linear_ray_angles(H: int = 64, W: int = 2048) -> np.ndarray:
    """(H, W, 2) HDL-64E ray angles in radians: elevation +3..-25 deg,
    azimuth +180..-180 deg (reference utils/lidar.py:9-20)."""
    h_up, h_down = 3.0, -25.0
    w_left, w_right = 180.0, -180.0
    elevation = (1 - np.arange(H) / H) * (h_up - h_down) + h_down
    azimuth = (1 - np.arange(W) / W) * (w_left - w_right) + w_right
    elevation, azimuth = np.meshgrid(elevation, azimuth, indexing="ij")
    angles = np.stack([elevation, azimuth], axis=-1)
    return np.deg2rad(angles).astype(np.float32)


def fourier_feature_frequencies(resolution: tuple[int, int]) -> np.ndarray:
    """Per-axis log2-spaced frequencies, shape (n_freqs, 2): the first
    ceil(log2 H) rows carry phi frequencies, the rest theta frequencies."""
    L_h = int(math.ceil(math.log2(resolution[0])))
    L_w = int(math.ceil(math.log2(resolution[1])))
    freqs_h = np.concatenate([np.exp2(np.arange(L_h)), np.zeros(L_w)])
    freqs_w = np.concatenate([np.zeros(L_h), np.exp2(np.arange(L_w))])
    return np.stack([freqs_h, freqs_w], axis=-1).astype(np.float32)


def fourier_features_channels(resolution: tuple[int, int]) -> int:
    L_h = int(math.ceil(math.log2(resolution[0])))
    L_w = int(math.ceil(math.log2(resolution[1])))
    return 2 * (L_h + L_w)


def fourier_features(angles: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """(H, W, 2) angles -> (H, W, 2*n_freqs) [sin | cos] features."""
    proj = angles @ freqs.T
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def spherical_harmonics(angles: torch.Tensor, levels: int = 5) -> torch.Tensor:
    """(H, W, 2) angles -> (H, W, levels**2) real SH basis of the view
    directions d = (cos(theta)cos(phi), -sin(theta)cos(phi), sin(phi))."""
    phi, theta = angles[..., 0], angles[..., 1]
    x = torch.cos(theta) * torch.cos(phi)
    y = -torch.sin(theta) * torch.cos(phi)
    z = torch.sin(phi)
    xx, yy, zz = x * x, y * y, z * z
    comps = [torch.full_like(x, 0.28209479177387814)]
    if levels > 1:
        comps += [
            0.4886025119029199 * y,
            0.4886025119029199 * z,
            0.4886025119029199 * x,
        ]
    if levels > 2:
        comps += [
            1.0925484305920792 * x * y,
            1.0925484305920792 * y * z,
            0.9461746957575601 * zz - 0.31539156525251999,
            1.0925484305920792 * x * z,
            0.5462742152960396 * (xx - yy),
        ]
    if levels > 3:
        comps += [
            0.5900435899266435 * y * (3 * xx - yy),
            2.890611442640554 * x * y * z,
            0.4570457994644658 * y * (5 * zz - 1),
            0.3731763325901154 * z * (5 * zz - 3),
            0.4570457994644658 * x * (5 * zz - 1),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3 * yy),
        ]
    if levels > 4:
        comps += [
            2.5033429417967046 * x * y * (xx - yy),
            1.7701307697799304 * y * z * (3 * xx - yy),
            0.9461746957575601 * x * y * (7 * zz - 1),
            0.6690465435572892 * y * z * (7 * zz - 3),
            0.10578554691520431 * (35 * zz * zz - 30 * zz + 3),
            0.6690465435572892 * x * z * (7 * zz - 3),
            0.47308734787878004 * (xx - yy) * (7 * zz - 1),
            1.7701307697799304 * x * z * (xx - 3 * yy),
            0.6258357354491761 * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(comps, dim=-1)


def timestep_embedding(
    t: torch.Tensor, channels: int, max_period: float = 10_000.0
) -> torch.Tensor:
    """Sinusoidal embedding (B,) -> (B, channels), always fp32: half sin,
    half cos, frequencies exp(-log(max_period) * i / (channels//2 - 1))."""
    half = channels // 2
    freqs = torch.exp(
        -math.log(max_period) / (half - 1)
        * torch.arange(half, dtype=torch.float32, device=t.device)
    )
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
