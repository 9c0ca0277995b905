"""Training observability: scalars to ``metrics.jsonl`` (and TensorBoard when
it imports), and the image panels the reference logs (train.py:220-245).

The port of ``r2dm_tpu/utils/logging.py``: the same JSONL lines, ``{"step",
"time", **metrics}``; the panels rendered with the port's ``render.py`` and
written by its PNG writer, with no plotting package.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .. import render
from ..colormaps import PLASMA

# matplotlib's binary_r: black to white
BINARY_R = np.repeat(np.linspace(0.0, 1.0, 256, dtype=np.float32)[:, None], 3, axis=1)


class MetricLogger:
    """Scalars -> ``<out_dir>/metrics.jsonl``, mirrored to TensorBoard under
    ``<out_dir>/tb`` if ``torch.utils.tensorboard`` imports (the reference's
    accelerate trackers, train.py:48, 58-59)."""

    def __init__(self, out_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._tb = None
        if enabled:
            os.makedirs(out_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(out_dir, "tb"))

    def log(self, step: int, metrics: dict) -> None:
        if not self.enabled:
            return
        rec = {"step": step, "time": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


def save_image_panels(
    out_dir: str,
    step: int,
    samples: torch.Tensor,  # (B, H, W, C) in [-1, 1]
    lidar_utils,  # NHWC
    channels: int,
    tag: str = "sample",
    max_images: int = 4,
) -> list[str]:
    """The reference's log_images (train.py:220-245): depth (turbo), mask
    (binary), a bird's-eye render shaded by surface normals and reflectance
    (plasma), each as one PNG with the samples stacked as rows, under
    ``<out_dir>/images/<step>_<tag>_<name>.png``."""
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    x = lidar_utils.denormalize(samples[:max_images].to(torch.float32))
    written = []

    def emit(name: str, rgb: torch.Tensor) -> None:
        tile = np.concatenate(list(rgb.cpu().numpy()), axis=0)  # stack rows
        path = os.path.join(img_dir, f"{step:08d}_{tag}_{name}.png")
        render.write_png(path, tile)
        written.append(path)

    if channels >= 1:
        depth_n = x[..., 0:1]
        emit("depth", render.colorize(depth_n))
        metric = lidar_utils.revert_depth(depth_n)
        mask = (metric > lidar_utils.min_depth) & (metric < lidar_utils.max_depth)
        emit("mask", render.colorize(mask[..., 0].to(torch.float32), BINARY_R))
        xyz = lidar_utils.to_xyz(metric) / lidar_utils.max_depth * mask
        normal = lidar_utils.denormalize(-render.estimate_surface_normal(xyz))
        B, H, W, _ = xyz.shape
        bev = render.render_point_clouds(
            points=xyz.reshape(B, H * W, 3), colors=normal.reshape(B, H * W, 3), size=512,
            t=torch.tensor([0.0, 0.0, 1.0], device=xyz.device),
        )
        emit("bev", torch.clamp(bev * 255, 0, 255).to(torch.uint8))
    if channels >= 2:
        emit("reflectance", render.colorize(x[..., 1], PLASMA))
    return written
