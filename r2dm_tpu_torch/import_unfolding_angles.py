"""Re-encode the reference's scan-unfolding angle tables.

    python -m r2dm_tpu_torch.import_unfolding_angles \
        --pth /path/to/reference/data/kitti_360/unfolding_angles.pth \
        --dataset kitti_360 [--out_dir DIR]

The counterpart of the JAX package's ``tools/import_unfolding_angles.py``,
host-only as there. The reference ships the per-pixel (elevation, azimuth)
tables of its "unfolding" projections as binaries
(``data/{kitti_360,kitti_raw}/unfolding_angles.pth``, read at its
train.py:102-107): calibration data measured from the scans, which cannot
be derived without them. The source must be a (1, 2, H, W) float32 tensor,
channel 0 the elevation (row means decreasing: the HDL-64E fires from +3
down to -25 degrees, within (-0.6, 0.2) rad) and channel 1 the azimuth in
[-pi, pi] (interior column means decreasing left to right), the
conventions of ``get_hdl64e_linear_ray_angles`` (reference
utils/lidar.py:9-20). It writes ``<dataset>_unfolding_angles.npz``, the
layout ``make_unfolding_angles`` writes, into ``--out_dir`` or else
``$R2DM_ANGLES_DIR``, and refuses with neither.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from .make_unfolding_angles import ANGLES_DIR_ENV, table_path, write_table


def convert(pth_path: str) -> np.ndarray:
    """The (H, W, 2) [elevation, azimuth] table of a reference ``.pth``."""
    arr = np.asarray(torch.load(pth_path, map_location="cpu", weights_only=True), dtype=np.float32)
    if arr.ndim != 4 or arr.shape[:2] != (1, 2):
        raise ValueError(f"expected a (1, 2, H, W) angle tensor, got {arr.shape}")
    angles = np.moveaxis(arr[0], 0, -1)
    validate(angles)
    return angles


def validate(angles: np.ndarray) -> None:
    elev, azim = angles[..., 0], angles[..., 1]
    if not (-0.6 < elev.min() and elev.max() < 0.2):
        raise ValueError(f"elevation out of the HDL-64E range: [{elev.min()}, {elev.max()}]")
    if not (np.diff(elev.mean(axis=1)) < 0).all():
        raise ValueError("elevation row means must decrease top to bottom")
    if not (-math.pi <= azim.min() and azim.max() <= math.pi):
        raise ValueError(f"azimuth out of [-pi, pi]: [{azim.min()}, {azim.max()}]")
    # interior columns only: at the +-pi seam the measured azimuths wrap, so
    # a linear mean of the first or last column can sit below its neighbour
    if not (np.diff(azim.mean(axis=0)[1:-1]) < 0).all():
        raise ValueError("azimuth column means must decrease left to right")


def main(args: argparse.Namespace) -> int:
    path = table_path(args.dataset, args.out_dir)
    angles = convert(args.pth)
    write_table(path, angles)
    print(f"wrote {path}: {angles.shape} float32, "
          f"elevation [{angles[..., 0].min():.4f}, {angles[..., 0].max():.4f}] rad, "
          f"azimuth [{angles[..., 1].min():.4f}, {angles[..., 1].max():.4f}] rad")
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pth", required=True, help="reference unfolding_angles.pth")
    p.add_argument("--dataset", required=True, choices=["kitti_360", "kitti_raw"])
    p.add_argument("--out_dir", default=None, help=f"output dir (default ${ANGLES_DIR_ENV})")
    return p.parse_args(argv)


if __name__ == "__main__":
    raise SystemExit(main(parse_args()))
