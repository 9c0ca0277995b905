"""Build the per-pixel (elevation, azimuth) angle table of the scan-unfolding
projections from raw scans.

    python -m r2dm_tpu_torch.make_unfolding_angles --dataset kitti_360 \
        --data_root /path/to/data_3d_raw [--num_scans 500] [--out_dir DIR]

The counterpart of the JAX package's ``tools/make_unfolding_angles.py``,
host-only numpy as there. The reference ships the tables as binaries
(data/{kitti_360,kitti_raw}/unfolding_angles.pth, loaded at its
train.py:102-107) measured from the dataset: for every pixel of the
unfolded 64 x ``--width`` grid, the circular mean direction of the points
that land there over up to ``--num_scans`` training scans; a pixel no point
reaches takes the HDL-64E linear grid's angles. It writes
``<dataset>_unfolding_angles.npz``, an (H, W, 2) float32 ``angles`` array
[elevation, azimuth] in radians, into ``--out_dir`` or else
``$R2DM_ANGLES_DIR``, where ``inference.py::model_coords`` reads it for
``projection="unfolding-*"``. With neither it refuses: the JAX package's
``r2dm_tpu/data/angles/``, the port's default for reading, is not written.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .data.datasets import KITTI360, KITTIRaw
from .data.projection import load_points_as_images
from .ops.encoding import get_hdl64e_linear_ray_angles

ANGLES_DIR_ENV = "R2DM_ANGLES_DIR"


def table_path(dataset: str, out_dir) -> str:
    """Where the table of ``dataset`` goes: ``out_dir``, else
    ``$R2DM_ANGLES_DIR``; exits with the reason when neither is set."""
    out_dir = out_dir or os.environ.get(ANGLES_DIR_ENV)
    if not out_dir:
        raise SystemExit(f"pass --out_dir or set ${ANGLES_DIR_ENV} (where model_coords reads the table); "
                         "the JAX package's r2dm_tpu/data/angles/ is only read")
    return os.path.join(out_dir, f"{dataset}_unfolding_angles.npz")


def write_table(path: str, angles: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, angles=angles.astype(np.float32))


def main(args: argparse.Namespace) -> int:
    path = table_path(args.dataset, args.out_dir)
    cls = {"kitti_360": KITTI360, "kitti_raw": KITTIRaw}[args.dataset]
    ds = cls(args.data_root, split="train", projection=f"unfolding-{args.width}")
    H, W = 64, args.width
    # circular means via per-angle sin/cos accumulation
    acc_sin = np.zeros((H, W, 2), np.float64)
    acc_cos = np.zeros((H, W, 2), np.float64)
    count = np.zeros((H, W, 1), np.float64)
    step = max(1, len(ds) // args.num_scans)
    used = 0
    for i in range(0, len(ds), step):
        planes = load_points_as_images(ds.file_paths[i], scan_unfolding=True, H=H, W=W)
        xyz, depth = planes[..., :3], planes[..., 4]
        valid = depth > 0
        with np.errstate(invalid="ignore", divide="ignore"):
            elevation = np.arcsin(np.where(valid, xyz[..., 2] / depth, 0.0))
            azimuth = np.arctan2(xyz[..., 1], xyz[..., 0])
        ang = np.stack([elevation, azimuth], axis=-1)
        v = valid[..., None]
        acc_sin += np.sin(ang) * v
        acc_cos += np.cos(ang) * v
        count += v
        used += 1
        if used % 50 == 0:
            print(f"{used} scans accumulated", flush=True)
    mean = np.arctan2(acc_sin, acc_cos)
    empty = count[..., 0] == 0
    mean[empty] = get_hdl64e_linear_ray_angles(H, W).astype(np.float64)[empty]
    write_table(path, mean)
    print(f"wrote {path} from {used} scans ({int(empty.sum())} empty pixels)")
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", choices=["kitti_360", "kitti_raw"], required=True)
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--width", type=int, default=2048)
    parser.add_argument("--num_scans", type=int, default=500)
    parser.add_argument("--out_dir", default=None, help=f"output dir (default ${ANGLES_DIR_ENV})")
    return parser.parse_args(argv)


if __name__ == "__main__":
    raise SystemExit(main(parse_args()))
