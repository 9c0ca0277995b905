"""Range-image datasets: KITTI-360, KITTI Raw, and a synthetic set for tests
and smoke training.

The port of ``r2dm_tpu/data/datasets.py``: scans given by .bin paths are
projected by the C++ core, optionally once into a per-split **memmap cache**
of (N, H, W, 6) float32 planes [x, y, z, reflectance, depth, mask] under
``cache_dir``. The cache keeps the JAX package's file name and ``.npy``
layout, so a cache either package built serves both. Rows are (H, W, 6)
planes with the invalid pixels zeroed, or reference-style dicts of NCHW
planes.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import kitti_splits as splits
from .projection import load_points_as_images, project_points


class RangeImageDataset:
    """Scans given by .bin paths, and an optional packed projection cache."""

    def __init__(
        self,
        file_paths: Sequence[str],
        projection: str = "spherical-1024",
        min_depth: float = 1.45,
        max_depth: float = 80.0,
        cache_dir: Optional[str] = None,
        cache_tag: str = "",
    ):
        proj, width = projection.split("-")
        if proj not in ("spherical", "unfolding"):
            raise ValueError(f"unknown projection: {projection}")
        self.file_paths = list(file_paths)
        self.scan_unfolding = proj == "unfolding"
        self.H, self.W = 64, int(width)
        self.min_depth = min_depth
        self.max_depth = max_depth
        self._cache: Optional[np.ndarray] = None
        if cache_dir is not None and self.file_paths:
            self._cache = self._build_cache(cache_dir, projection, cache_tag)

    def cache_path(self, cache_dir: str, projection: str, tag: str) -> Path:
        """``<tag>-<projection>-<n>-<sha1 of the paths>.npy``, as the JAX
        package names it (r2dm_tpu/data/datasets.py:51-56)."""
        digest = hashlib.sha1("\n".join(map(str, self.file_paths)).encode()).hexdigest()[:12]
        return Path(cache_dir) / f"{tag or 'scans'}-{projection}-{len(self.file_paths)}-{digest}.npy"

    def _build_cache(self, cache_dir: str, projection: str, tag: str) -> np.ndarray:
        path = self.cache_path(cache_dir, projection, tag)
        if not path.exists():
            os.makedirs(cache_dir, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp.npy")
            arr = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.float32,
                                            shape=(len(self.file_paths), self.H, self.W, 6))
            for i, fp in enumerate(self.file_paths):
                arr[i] = self.project_file(fp)
            arr.flush()
            del arr
            os.replace(tmp, path)
        return np.load(path, mmap_mode="r")

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
        if self._cache is not None:
            planes = np.array(self._cache[index])
        else:
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


class KITTI360(RangeImageDataset):
    """KITTI-360 with the lidargen sequence splits (reference
    kitti_360.py:19-24, 141-154): train = sequences {3, 4, 5, 6, 7, 9, 10},
    test = {0, 2}, all = both; scans from
    ``<root>/*_<seq:04d>_sync/velodyne_points/data/*.bin``, sorted."""

    def __init__(self, root: str, split: str = "train", projection: str = "spherical-1024",
                 cache_dir: Optional[str] = None, **kw):
        if split == "all":
            seqs = splits.KITTI360_SEQUENCE_SPLITS["train"] + splits.KITTI360_SEQUENCE_SPLITS["test"]
        else:
            seqs = splits.KITTI360_SEQUENCE_SPLITS[split]
        file_paths: list[str] = []
        for seq in seqs:
            pattern = f"*_{seq:04d}_sync/velodyne_points/data/*.bin"
            file_paths += sorted(str(p) for p in Path(root).glob(pattern))
        super().__init__(file_paths, projection=projection, cache_dir=cache_dir,
                         cache_tag=f"kitti360-{split}", **kw)


class KITTIRaw(RangeImageDataset):
    """KITTI Raw with odometry-based splits (reference kitti_raw.py:19-23,
    334-360): train/validation = odometry sequences mapped to raw drives
    (sequence 3's drive is not in KITTI Raw and is skipped), test = the
    city, road and residential drives outside them
    (``kitti_splits.raw_test_drives``)."""

    def __init__(self, root: str, split: str = "train", projection: str = "spherical-1024",
                 cache_dir: Optional[str] = None, **kw):
        file_paths: list[str] = []
        if split in ("train", "validation"):
            for seq in splits.KITTIRAW_SEQUENCE_SPLITS[split]:
                if seq == 3:
                    continue  # drive 2011_09_26_0067 is not in KITTI Raw
                date, drive, start, end = splits.ODOMETRY_TO_RAW[seq]
                base = Path(root) / date / splits.drive_name(date, drive) / "velodyne_points" / "data"
                file_paths += [str(base / f"{i:010d}.bin") for i in range(start, end + 1)]
        elif split == "test":
            for name in splits.raw_test_drives():
                base = Path(root) / name[:10] / name / "velodyne_points" / "data"
                file_paths += sorted(str(p) for p in base.glob("*.bin"))
        else:
            raise ValueError(f"unknown split: {split}")
        super().__init__(file_paths, projection=projection, cache_dir=cache_dir,
                         cache_tag=f"kittiraw-{split}", **kw)


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


def make_dataset(
    dataset: str, root: Optional[str], split: str, projection: str, cache_dir: Optional[str] = None,
) -> RangeImageDataset:
    """Config-driven factory (reference ds.load_dataset, train.py:165-172).
    ``cache_dir`` holds the KITTI sets' projection cache. ``$R2DM_SYNTH_SCANS``
    sets the synthetic set's size (default 64), as in the JAX package."""
    if dataset == "kitti_360":
        return KITTI360(root, split=split, projection=projection, cache_dir=cache_dir)
    if dataset == "kitti_raw":
        return KITTIRaw(root, split=split, projection=projection, cache_dir=cache_dir)
    if dataset == "synthetic":
        num_scans = int(os.environ.get("R2DM_SYNTH_SCANS", "64"))
        return SyntheticLiDAR(num_scans=num_scans, projection=projection)
    raise ValueError(f"unknown dataset: {dataset}")
