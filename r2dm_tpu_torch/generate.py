"""Generate LiDAR scans from a checkpoint and render previews.

    python -m r2dm_tpu_torch.generate --ckpt path/to/checkpoint.msgpack

The port's counterpart of the repo's ``generate.py``: loads a checkpoint
(the JAX package's msgpack or a reference ``.pth``), samples with per-sample
seeds and a progress line, and writes ``samples_img.png`` (the channels of
each scan stacked, turbo colours) and ``samples_bev.png`` (a bird's-eye
render, viridis height colours). ``--video`` writes the reverse process as
a PNG frame sequence under ``samples_frames/``. On CUDA the network computes
in bfloat16 (the kernels' type), so ``--bf16`` is implied there. ``--int8``
runs the ring convs on the W8A8 serving lane (``models/layers.py::
set_quant_conv``; on the card the s8 ring-conv kernel), as the JAX
``generate.py --int8`` does. ``--latency_layout`` builds the network with
``width_merge_l1=True``, the JAX package's W2C layout (``EfficientUNet``:
the same math on the NHWC kernels, so the samples do not change).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from . import render as render_lib
from .colormaps import VIRIDIS
from .inference import setup_model
from .lidar import LiDARUtility
from .models.layers import set_quant_conv

MODES = ("ddpm", "ddim", "dpmpp_2m", "euler", "midpoint")
MAX_FRAMES = 128


def render_panels(x: torch.Tensor, lidar_utils: LiDARUtility) -> tuple[np.ndarray, np.ndarray]:
    """x: (B, H, W, C) in [0, 1] with x[..., 0] = metric depth / max_depth,
    and ``lidar_utils`` in NHWC. Returns (range-image RGB, BEV RGB) uint8
    (reference generate.py:44-59)."""
    B, H, W, C = x.shape
    img = render_lib.colorize(x.permute(0, 3, 1, 2).reshape(B, C * H, W))
    xyz = lidar_utils.to_xyz(x[..., 0:1] * lidar_utils.max_depth) / lidar_utils.max_depth
    z_min, z_max = -2 / lidar_utils.max_depth, 0.5 / lidar_utils.max_depth
    z = torch.clamp((xyz[..., 2] - z_min) / (z_max - z_min), 0, 1)
    colors = render_lib.colorize(z, VIRIDIS).to(torch.float32) / 255.0
    R, t = render_lib.make_Rt(pitch=np.pi / 3, yaw=np.pi / 4, z=0.8, device=x.device)
    bev = 1.0 - render_lib.render_point_clouds(
        points=xyz.reshape(B, H * W, 3), colors=1.0 - colors.reshape(B, H * W, 3), R=R, t=t,
    )
    bev = torch.clamp(bev * 255, 0, 255).to(torch.uint8)
    return img.cpu().numpy(), bev.cpu().numpy()


def main(args: argparse.Namespace) -> int:
    device = torch.device(args.device)
    bf16 = args.bf16 or device.type == "cuda"
    ddpm, lidar_utils, _ = setup_model(args.ckpt, dtype=torch.bfloat16 if bf16 else None, device=device,
                                       width_merge_l1=args.latency_layout)
    if args.int8:
        set_quant_conv(ddpm.model, "w8a8")
        print("--int8: ring convs on the W8A8 lane", file=sys.stderr)
    xs = ddpm.sample(
        batch_size=args.batch_size,
        num_steps=args.sampling_steps,
        mode=args.mode,
        seeds=list(range(args.seed, args.seed + args.batch_size)),
        return_all=args.video,
        data_format="NHWC",
        progress=True,
    )
    xs = torch.clamp(xs, -1, 1)
    lidar_utils.data_format = "NHWC"

    def to_unit(x):
        x = lidar_utils.denormalize(x)
        depth = lidar_utils.revert_depth(x[..., 0:1]) / lidar_utils.max_depth
        return torch.cat([depth, x[..., 1:]], dim=-1)

    os.makedirs(args.out_dir, exist_ok=True)
    img, bev = render_panels(to_unit(xs[-1] if args.video else xs), lidar_utils)
    render_lib.write_png(os.path.join(args.out_dir, "samples_img.png"), np.concatenate(list(img), axis=0))
    render_lib.write_png(os.path.join(args.out_dir, "samples_bev.png"), np.concatenate(list(bev), axis=1))
    print(f"wrote samples_img.png, samples_bev.png to {args.out_dir}")
    if args.video:
        frames_dir = os.path.join(args.out_dir, "samples_frames")
        os.makedirs(frames_dir, exist_ok=True)
        stride = max(1, len(xs) // MAX_FRAMES)
        keep = [i for i in range(len(xs)) if i % stride == 0 or i == len(xs) - 1]
        for n, i in enumerate(keep):
            img, _ = render_panels(to_unit(xs[i]), lidar_utils)
            render_lib.write_png(os.path.join(frames_dir, f"frame_{n:04d}.png"), np.concatenate(list(img), axis=1))
        print(f"wrote {len(keep)} frames to {frames_dir} (ffmpeg -r 60 -i frame_%04d.png samples.mp4)")
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--mode", choices=MODES, default="ddpm")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--sampling_steps", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute (implied on CUDA)")
    parser.add_argument("--int8", action="store_true", help="W8A8 int8 ring convs (the serving lane)")
    parser.add_argument("--latency_layout", action="store_true", help="width-pair-merged level 1 (W2C layout)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--out_dir", type=str, default=".", help="where the PNGs go")
    return parser.parse_args(argv)


if __name__ == "__main__":
    sys.exit(main(parse_args()))
