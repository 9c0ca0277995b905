"""Range-image datasets: a list of scans projected on demand, and a
synthetic set for tests and smoke training.

The port of ``r2dm_tpu/data/datasets.py`` (:27-106, 182-260) without its
memmap cache of projected planes. Rows are (H, W, 6) float32 planes [x, y,
z, reflectance, depth, mask] with the invalid pixels zeroed, or reference-
style dicts of NCHW planes. KITTI-360 and KITTI Raw (their sequence splits
and file layouts, ``r2dm_tpu/data/kitti_splits.py``) are not ported yet:
``make_dataset`` raises for them.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .projection import load_points_as_images, project_points

KITTI_ITEM = "ROADMAP.md queue 1: the KITTI datasets, kitti_splits and the native projection core"


class RangeImageDataset:
    """Scans given by .bin paths, each projected when it is read."""

    def __init__(
        self,
        file_paths: Sequence[str],
        projection: str = "spherical-1024",
        min_depth: float = 1.45,
        max_depth: float = 80.0,
    ):
        proj, width = projection.split("-")
        if proj not in ("spherical", "unfolding"):
            raise ValueError(f"unknown projection: {projection}")
        self.file_paths = list(file_paths)
        self.scan_unfolding = proj == "unfolding"
        self.H, self.W = 64, int(width)
        self.min_depth = min_depth
        self.max_depth = max_depth

    def project_file(self, fp: str) -> np.ndarray:
        return load_points_as_images(
            fp, scan_unfolding=self.scan_unfolding, H=self.H, W=self.W,
            min_depth=self.min_depth, max_depth=self.max_depth,
        )

    def __len__(self) -> int:
        return len(self.file_paths)

    def planes(self, index: int) -> np.ndarray:
        """(H, W, 6) float32, invalid pixels zeroed (the reference multiplies
        by the mask plane, kitti_360.py:165)."""
        planes = self.project_file(self.file_paths[index])
        return planes * planes[..., 5:6]

    def __getitem__(self, index: int) -> dict:
        """Reference-style row (NCHW planes, kitti_360.py:166-172)."""
        p = self.planes(index).transpose(2, 0, 1)
        return {
            "sample_id": np.int32(index),
            "xyz": p[:3],
            "reflectance": p[3:4],
            "depth": p[4:5],
            "mask": p[5:6],
        }


class SyntheticLiDAR(RangeImageDataset):
    """Procedural stand-in (a ground plane and random walls), deterministic
    per index: the same planes as the JAX package's ``SyntheticLiDAR`` for
    the same seed and index. Each scan is generated once and kept."""

    def __init__(self, num_scans: int = 64, projection: str = "spherical-1024", seed: int = 0, **kw):
        self.num_scans = num_scans
        self.seed = seed
        # generating and projecting a scan takes ~0.1 s on one core and the
        # loader reads every scan each epoch; deterministic per index, so the
        # memo is exact (two loader threads may compute one index twice)
        self._memo: dict[int, np.ndarray] = {}
        super().__init__([f"synthetic://{i}" for i in range(num_scans)], projection=projection, **kw)

    def planes(self, index: int) -> np.ndarray:
        got = self._memo.get(index)
        if got is None:
            got = self._memo[index] = super().planes(index)
        return got

    def project_file(self, fp: str) -> np.ndarray:
        index = int(fp.split("://")[1])
        rng = np.random.default_rng(self.seed * 100_003 + index)
        n = 60_000
        azimuth = rng.uniform(-np.pi, np.pi, n)
        # ground plane at z = -1.7 m seen from rings + scattered obstacles
        r_ground = rng.uniform(2.0, 75.0, n)
        x = r_ground * np.cos(azimuth)
        y = r_ground * np.sin(azimuth)
        z = np.full(n, -1.7) + rng.normal(0, 0.02, n)
        # boxes: vertical walls at random azimuth / distance
        m = n // 4
        wall_az = rng.uniform(-np.pi, np.pi, m)
        wall_r = rng.uniform(3.0, 40.0, m)
        x[:m] = wall_r * np.cos(wall_az)
        y[:m] = wall_r * np.sin(wall_az)
        z[:m] = rng.uniform(-1.7, 1.5, m)
        refl = rng.uniform(0.0, 1.0, n)
        points = np.stack([x, y, z, refl], axis=1).astype(np.float32)
        return project_points(
            points, scan_unfolding=self.scan_unfolding, H=self.H, W=self.W,
            min_depth=self.min_depth, max_depth=self.max_depth,
        )


def make_dataset(dataset: str, root: Optional[str], split: str, projection: str) -> RangeImageDataset:
    """Config-driven factory (reference ds.load_dataset, train.py:165-172).
    ``$R2DM_SYNTH_SCANS`` sets the synthetic set's size (default 64), as in
    the JAX package."""
    if dataset in ("kitti_360", "kitti_raw"):
        raise NotImplementedError(f"dataset {dataset!r} is not ported yet ({KITTI_ITEM}); use 'synthetic'")
    if dataset == "synthetic":
        num_scans = int(os.environ.get("R2DM_SYNTH_SCANS", "64"))
        return SyntheticLiDAR(num_scans=num_scans, projection=projection)
    raise ValueError(f"unknown dataset: {dataset}")
