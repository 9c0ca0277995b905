"""Point-cloud rendering and visualisation (torch, NHWC).

Port of ``r2dm_tpu/render.py`` (reference ``utils/render.py``): the pinhole
BEV renderer with a soft z-buffer (:9-80), the bilinear splatting
rasteriser (:83-142; four scatter-adds with ``index_add_``), 8-neighbour
cross-product surface normals (:145-236) and the colour lookup (:239-247).
The colour tables are the port's own (``colormaps.py``), and ``write_png``
writes images with the standard library alone.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional

import numpy as np
import torch

from .colormaps import TURBO


def make_Rt(
    roll: float = 0.0, pitch: float = 0.0, yaw: float = 0.0,
    x: float = 0.0, y: float = 0.0, z: float = 0.0, device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Extrinsics: R = Rz(yaw) @ Ry(pitch) @ Rx(roll) (1, 3, 3), t = [x, y, z]
    (1, 3) (reference utils/render.py:9-29)."""

    def rx(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def ry(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rz(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    R = rz(yaw) @ ry(pitch) @ rx(roll)
    return (
        torch.tensor(R[None], dtype=torch.float32, device=device),
        torch.tensor([[x, y, z]], dtype=torch.float32, device=device),
    )


def bilinear_rasterizer(coords: torch.Tensor, values: torch.Tensor, out_shape: tuple[int, int]) -> torch.Tensor:
    """Splat (B, N, C) values at (B, N, 2) (h, w) coordinates onto
    (B, H, W, C): each point's four corner weights added with ``index_add_``
    (reference utils/render.py:83-142)."""
    B, N, C = values.shape
    H, W = out_shape
    h, w = coords[..., 0], coords[..., 1]
    h_t = torch.floor(h)
    h_b = h_t + 1
    w_l = torch.floor(w)
    w_r = w_l + 1
    h_t_safe = torch.clamp(h_t, 0.0, H - 1)
    h_b_safe = torch.clamp(h_b, 0.0, H - 1)
    w_l_safe = torch.clamp(w_l, 0.0, W - 1)
    w_r_safe = torch.clamp(w_r, 0.0, W - 1)
    wh_t = (h_b - h) * (h_t == h_t_safe)
    wh_b = (h - h_t) * (h_b == h_b_safe)
    ww_l = (w_r - w) * (w_l == w_l_safe)
    ww_r = (w - w_l) * (w_r == w_r_safe)
    weights = torch.stack([wh_t * ww_l, wh_t * ww_r, wh_b * ww_l, wh_b * ww_r])  # (4, B, N)
    hs = torch.stack([h_t_safe, h_t_safe, h_b_safe, h_b_safe])
    ws = torch.stack([w_l_safe, w_r_safe, w_l_safe, w_r_safe])
    weights = weights * (weights >= 1e-3)  # stability gate (reference :120-123)
    batch = torch.arange(B, device=values.device).reshape(1, B, 1) * (H * W)
    idx = (ws + W * hs).to(torch.int64) + batch  # (4, B, N)
    out = torch.zeros((B * H * W, C), dtype=values.dtype, device=values.device)
    out.index_add_(0, idx.reshape(-1), (values[None] * weights[..., None]).reshape(-1, C))
    return out.reshape(B, H, W, C)


def render_point_clouds(
    points: torch.Tensor,
    colors: Optional[torch.Tensor] = None,
    size: int = 800,
    R: Optional[torch.Tensor] = None,
    t: Optional[torch.Tensor] = None,
    focal_length: float = 1.0,
) -> torch.Tensor:
    """Pinhole render of (B, N, 3) points -> (B, size, size, C) with a soft
    exp(-3 depth) z-buffer (reference utils/render.py:32-80)."""
    points = points * torch.tensor([1.0, 1.0, -1.0], device=points.device)  # flip z
    B, N, _ = points.shape
    if colors is None:
        colors = torch.ones((B, N, 3), dtype=points.dtype, device=points.device)
    if R is not None:
        points = points @ R
    if t is not None:
        points = points + t
    # intrinsics: fx = fy = focal_length, cx = cy = 0.5 (points in [-1, 1])
    zs = points[..., 2:3]
    uv = points[..., :2] / torch.where(torch.abs(zs) > 0, zs, torch.ones_like(zs))
    uv = uv * focal_length + 0.5
    uv = uv * size
    inside = (uv > 0) & (uv < size - 1)
    colors = colors * (inside[..., 0:1] & inside[..., 1:2])
    uv = size - uv
    depth = torch.linalg.norm(points, dim=-1, keepdim=True)
    weight = torch.exp(-3.0 * depth) * (depth > 1e-8)
    num = bilinear_rasterizer(uv, weight * colors, (size, size))
    den = bilinear_rasterizer(uv, weight, (size, size))
    return num / (den + 1e-8)


def estimate_surface_normal(points: torch.Tensor, d: int = 2, mode: str = "closest") -> torch.Tensor:
    """Surface normals of a (B, H, W, 3) point map from cross products over 8
    neighbour pairs at distance ``d`` (reference utils/render.py:145-236):
    H padded by replication, W circularly; 'closest' picks the pair nearest
    the anchor, 'mean' averages all eight."""
    B, H, W, C = points.shape
    assert C == 3
    P = torch.cat([points[:, :1].expand(B, d, W, C), points, points[:, -1:].expand(B, d, W, C)], dim=1)
    P = torch.cat([P[:, :, W - d:], P, P[:, :, :d]], dim=2)
    offsets = [(-d, 0), (-d, d), (0, d), (d, d), (d, 0), (d, -d), (0, -d), (-d, -d)]

    def shift(dh, dw):
        return P[:, d + dh:d + dh + H, d + dw:d + dw + W]

    anchors = shift(0, 0)
    v1 = torch.stack([shift(*o) for o in offsets], dim=1) - anchors[:, None]  # (B, 8, H, W, 3)
    v2 = torch.stack([shift(*offsets[(k + 2) % 8]) for k in range(8)], dim=1) - anchors[:, None]
    cross = torch.linalg.cross(v1, v2, dim=-1)
    if mode == "closest":
        diff = torch.linalg.norm(v1, dim=-1) + torch.linalg.norm(v2, dim=-1)
        i = torch.argmin(diff, dim=1)  # (B, H, W)
        normals = torch.take_along_dim(cross, i[:, None, :, :, None], dim=1)[:, 0]
    elif mode == "mean":
        normals = cross.mean(dim=1)
    else:
        raise NotImplementedError(mode)
    return normals / (torch.linalg.norm(normals, dim=-1, keepdim=True) + 1e-8)


def colorize(x: torch.Tensor, lut: Optional[np.ndarray] = None) -> torch.Tensor:
    """A [0, 1] map (B, H, W) or (B, H, W, 1) -> uint8 RGB (B, H, W, 3)
    through a 256-entry table (reference utils/render.py:239-247; default
    turbo)."""
    if x.dim() == 4:
        x = x[..., 0]
    table = torch.as_tensor(TURBO if lut is None else np.asarray(lut, np.float32), device=x.device)
    ids = torch.clamp(x * 256.0, 0, 255).to(torch.int64)
    return torch.clamp(table[ids] * 255.0, 0, 255).to(torch.uint8)


def write_png(path: str, image: np.ndarray) -> None:
    """Write a uint8 (H, W), (H, W, 3) or (H, W, 4) image as an 8-bit PNG
    (zlib and struct only)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    H, W, C = image.shape
    color_type = {1: 0, 3: 2, 4: 6}[C]
    rows = np.concatenate([np.zeros((H, 1), np.uint8), image.reshape(H, W * C)], axis=1)  # filter 0 a row

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
