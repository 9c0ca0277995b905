"""Synthetic LiDAR scans for the training cells, made from the run's seed.

A frozen copy of the port's procedural stand-in for KITTI-360
(``SyntheticLiDAR``: a ground plane at z = -1.7 m seen out to 75 m and random
vertical walls 3-40 m away, 60,000 points with uniform reflectance), and of
the reference's spherical projection to the HDL-64E grid (elevation +3 to
-25 degrees, the nearest point winning each pixel, ties to the later point):
(H, W, 6) float32 planes [x, y, z, reflectance, depth, mask], zeroed where
the mask is 0. Scan ``i`` of seed ``s`` is drawn from
``np.random.default_rng(s * 100003 + i)``.
"""

from __future__ import annotations

import numpy as np

H_UP, H_DOWN = np.deg2rad(3.0), np.deg2rad(-25.0)
POINTS = 60_000
MIN_DEPTH, MAX_DEPTH = 1.45, 80.0


def project(points: np.ndarray, H: int, W: int) -> np.ndarray:
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    depth = np.sqrt(x * x + y * y + z * z)
    grid_w = np.clip(np.floor((((-np.arctan2(y, x)) / np.pi + 1) / 2) % 1 * W), 0, W - 1).astype(np.int64)
    with np.errstate(invalid="ignore", divide="ignore"):
        elevation = np.arcsin(np.where(depth > 0, z / depth, 0.0)) - H_DOWN
    grid_h = np.clip(np.floor((1 - elevation / (H_UP - H_DOWN)) * H), 0, H - 1).astype(np.int64)
    depth = depth.astype(np.float32)
    cell = grid_h * W + grid_w
    idx = np.arange(len(points))
    order = np.lexsort((-idx, depth, cell))
    first = np.ones(len(order), dtype=bool)
    first[1:] = cell[order][1:] != cell[order][:-1]
    win = order[first]
    out = np.zeros((H * W, 6), dtype=np.float32)
    out[cell[win], :4] = points[win]
    out[cell[win], 4] = depth[win]
    out[cell[win], 5] = ((depth[win] >= MIN_DEPTH) & (depth[win] <= MAX_DEPTH)).astype(np.float32)
    out = out.reshape(H, W, 6)
    return out * out[..., 5:6]


def scan(seed: int, index: int, H: int = 64, W: int = 1024) -> np.ndarray:
    rng = np.random.default_rng(seed * 100_003 + index)
    azimuth = rng.uniform(-np.pi, np.pi, POINTS)
    r = rng.uniform(2.0, 75.0, POINTS)
    x, y = r * np.cos(azimuth), r * np.sin(azimuth)
    z = np.full(POINTS, -1.7) + rng.normal(0, 0.02, POINTS)
    m = POINTS // 4
    wall_az = rng.uniform(-np.pi, np.pi, m)
    wall_r = rng.uniform(3.0, 40.0, m)
    x[:m], y[:m] = wall_r * np.cos(wall_az), wall_r * np.sin(wall_az)
    z[:m] = rng.uniform(-1.7, 1.5, m)
    refl = rng.uniform(0.0, 1.0, POINTS)
    return project(np.stack([x, y, z, refl], axis=1).astype(np.float32), H, W)


class ScanPool:
    """``n`` scans of ``seed``, made once; the dataset interface the port's
    ``DataLoader`` reads (``len`` and ``planes``)."""

    def __init__(self, seed: int, n: int, H: int = 64, W: int = 1024):
        self.scans = np.stack([scan(seed, i, H, W) for i in range(n)])

    def __len__(self) -> int:
        return len(self.scans)

    def planes(self, index: int) -> np.ndarray:
        return self.scans[index]
