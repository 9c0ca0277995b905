"""Point cloud -> equirectangular range image, on the host in numpy.

The port's own copy of ``r2dm_tpu/data/projection.py::project_points_numpy``
(reference ``load_points_as_images``, data/kitti_360/kitti_360.py:34-93):
depth = ||xyz||, a validity mask in [min_depth, max_depth], rows by scan
unfolding (ring index recovered from the counterclockwise point order) or
by spherical elevation bins (+3..-25 deg), columns by azimuth, and a
z-buffer in which the nearest point wins each pixel (ties to the later
point).

Two implementations with the same planes (to 1e-6):
- ``project_points``: the C++ core ``csrc/projection.cc`` (the port's copy of
  ``r2dm_tpu/data/native/projection.cc``), built with g++ at first use and
  bound by ctypes; a failed build raises;
- ``project_points_numpy``: vectorized numpy with a deterministic sort and
  unique-cell select, the plain version the tests hold the core against.

Output layout: (H, W, 6) float32 planes [x, y, z, reflectance, depth, mask].
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import build

H_UP = np.deg2rad(3.0)
H_DOWN = np.deg2rad(-25.0)


def _grids(points: np.ndarray, scan_unfolding: bool, H: int, W: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-point (grid_h, grid_w, depth)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    depth = np.sqrt(x * x + y * y + z * z)

    azimuth = -np.arctan2(y, x)
    grid_w = ((azimuth / np.pi + 1) / 2) % 1
    grid_w = np.clip(np.floor(grid_w * W), 0, W - 1).astype(np.int64)

    if scan_unfolding:
        # ring recovery from the counterclockwise point stream
        # (reference kitti_360.py:52-74)
        quads = np.where(y >= 0, np.where(x >= 0, 0, 1), np.where(x >= 0, 3, 2)).astype(np.int32)
        diff = np.roll(quads, 1) - quads
        delims = np.flatnonzero(diff == 3)
        grid_h = np.zeros(len(points), dtype=np.int64)
        if len(delims):
            bounds = np.concatenate([delims, [len(points)]])
            ring = H - 1
            for s in range(len(delims) - 1, -1, -1):
                row = ring if ring >= 0 else H + ring  # -1 wraps to H-1
                grid_h[bounds[s]:bounds[s + 1]] = row
                if ring >= 0:
                    ring -= 1
                else:
                    break
    else:
        with np.errstate(invalid="ignore", divide="ignore"):
            elevation = np.arcsin(np.where(depth > 0, z / depth, 0.0)) - H_DOWN
        gh = 1 - elevation / (H_UP - H_DOWN)
        grid_h = np.clip(np.floor(gh * H), 0, H - 1).astype(np.int64)

    return grid_h, grid_w, depth.astype(np.float32)


def project_points_numpy(
    points: np.ndarray,
    scan_unfolding: bool = True,
    H: int = 64,
    W: int = 2048,
    min_depth: float = 1.45,
    max_depth: float = 80.0,
) -> np.ndarray:
    """(n, 4) points [x, y, z, reflectance] -> (H, W, 6) float32 planes."""
    points = np.ascontiguousarray(points, dtype=np.float32)
    grid_h, grid_w, depth = _grids(points, scan_unfolding, H, W)
    cell = grid_h * W + grid_w

    # nearest wins, ties toward the later point: sort by (cell, depth,
    # -index) and keep the first row of each cell
    idx = np.arange(len(points))
    order = np.lexsort((-idx, depth, cell))
    cells_sorted = cell[order]
    first = np.ones(len(order), dtype=bool)
    first[1:] = cells_sorted[1:] != cells_sorted[:-1]
    winners = order[first]
    win_cells = cell[winners]

    out = np.zeros((H * W, 6), dtype=np.float32)
    out[win_cells, :4] = points[winners]
    out[win_cells, 4] = depth[winners]
    out[win_cells, 5] = ((depth[winners] >= min_depth) & (depth[winners] <= max_depth)).astype(np.float32)
    return out.reshape(H, W, 6)


def _native() -> ctypes.CDLL:
    lib = build.load_host("projection")
    if lib.project_scan.argtypes is None:
        lib.project_scan.restype = ctypes.c_int
        lib.project_scan.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # points (n, 4)
            ctypes.c_int64,                  # n
            ctypes.c_int,                    # H
            ctypes.c_int,                    # W
            ctypes.c_int,                    # scan_unfolding
            ctypes.c_float,                  # min_depth
            ctypes.c_float,                  # max_depth
            ctypes.POINTER(ctypes.c_float),  # out (H, W, 6), zeroed
        ]
    return lib


def project_points(
    points: np.ndarray,
    scan_unfolding: bool = True,
    H: int = 64,
    W: int = 2048,
    min_depth: float = 1.45,
    max_depth: float = 80.0,
) -> np.ndarray:
    """(n, 4) points [x, y, z, reflectance] -> (H, W, 6) float32 planes,
    through the C++ core."""
    points = np.ascontiguousarray(points, dtype=np.float32)
    if points.ndim != 2 or points.shape[1] != 4:
        raise ValueError(f"points must be (n, 4), got {points.shape}")
    out = np.zeros((H, W, 6), dtype=np.float32)
    ret = _native().project_scan(
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(points.shape[0]),
        H, W, int(scan_unfolding), ctypes.c_float(min_depth), ctypes.c_float(max_depth),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if ret != 0:
        raise RuntimeError(f"project_scan returned {ret}")
    return out


def load_points_as_images(
    point_path: str,
    scan_unfolding: bool = True,
    H: int = 64,
    W: int = 2048,
    min_depth: float = 1.45,
    max_depth: float = 80.0,
) -> np.ndarray:
    """Read a raw Velodyne ``.bin`` (float32 x, y, z, reflectance) and
    project it (reference kitti_360.py:34-43)."""
    points = np.fromfile(point_path, dtype=np.float32).reshape(-1, 4)
    return project_points(points, scan_unfolding, H, W, min_depth, max_depth)
