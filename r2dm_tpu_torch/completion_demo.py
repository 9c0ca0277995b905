"""RePaint completion demo: corrupt a test scan four ways, complete it with
the diffusion model, optionally label the completions with RangeNet-53, and
write a figure.

    python -m r2dm_tpu_torch.completion_demo --ckpt ckpt.msgpack [--rangenet_tar darknet53.tar.gz]
    python -m r2dm_tpu_torch.completion_demo --device cpu ...   # on the CPU
    torchrun --nproc_per_node N -m r2dm_tpu_torch.completion_demo ...   # the mask rows over N cards

The port's counterpart of the repo's ``completion_demo.py`` (reference
completion_demo.py:18-167): one scan of the test split, the masks full /
every 4th beam / a random half of the beams / 10 % of the points,
``DDPM.repaint`` over the T x r x j grid, and with ``--rangenet_tar`` the
semantic labels of the completed scans. The figure,
``completion_T-####_r-####_j-####.png`` in the working directory, is a grid of
panels written with ``render.write_png``: one column per mask (in that
order), and top to bottom the input's depth and reflectance (turbo), its
bird's-eye view, the completion's depth and reflectance, its labels
(SemanticKITTI colours, with ``--rangenet_tar``) and its bird's-eye view
(viridis by height, or the label colours). ``--few_step`` is the 8 x 4 x 1
grid in bf16 with the W2C latency layout. On CUDA the network computes in
bfloat16, the kernels' type. ``--latency_layout`` builds the network with
``width_merge_l1=True`` (``EfficientUNet``: the same math on the NHWC
kernels).

Under ``torchrun`` the four mask rows are split over the data axis (each
row has its own seed, so a row does not depend on its rank) and gathered to
rank 0, which labels them and writes the figure. ``--mesh`` ('N' or 'DxW')
must multiply to the world size, and D divide the four rows; with W > 1 the
W ranks of a data group complete the same rows, each its columns
(``DDPM.repaint(world=)``), the interactive latency lane of the JAX package
(completion_demo.py:79-92).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import parallel
from . import render as render_lib
from .colormaps import VIRIDIS
from .data import make_dataset, nearest_exact_resize
from .inference import setup_model
from .lidar import LiDARUtility
from .metrics.extractor import rangenet as rn
from .metrics.extractor import strict_fp32

BATCH = 4  # one scan per mask
BEV_SIZE = 800  # render.render_point_clouds' default


def apply_few_step_preset(args: argparse.Namespace) -> argparse.Namespace:
    """--few_step: the 8 x 4 x 1 RePaint grid in bf16 with the W2C latency
    layout, filling only the values left at their defaults (JAX
    completion_demo.py:25-36)."""
    if args.num_steps == 32:
        args.num_steps = 8
    if args.num_resample_steps == 16:
        args.num_resample_steps = 4
    args.bf16 = True
    args.latency_layout = True
    return args


def make_masks(rng: np.random.Generator, H: int, W: int) -> np.ndarray:
    """(4, H, W, 2) masks, 1 = known (reference completion_demo.py:78-88)."""
    mask = np.zeros((BATCH, H, W, 2), np.float32)
    mask[0] = 1.0
    mask[1, ::4] = 1.0  # 25 % of the beams
    mask[2] = (rng.uniform(size=(H, 1, 1)) < 0.5).astype(np.float32)
    mask[3] = (rng.uniform(size=(H, W, 1)) < 0.1).astype(np.float32)
    return mask


def _pad(img: np.ndarray, width: int) -> np.ndarray:
    """Centre a uint8 (h, w, 3) panel on a white strip ``width`` wide."""
    left = (width - img.shape[1]) // 2
    return np.pad(img, ((0, 4), (left, width - img.shape[1] - left), (0, 0)), constant_values=255)


def figure(lidar: LiDARUtility, x_in: torch.Tensor, x_out: torch.Tensor, labels) -> np.ndarray:
    """The uint8 RGB grid of panels (NHWC inputs, ``lidar`` in NHWC)."""

    def range_images(x):
        img = lidar.denormalize(x)
        d = lidar.revert_depth(img[..., 0:1]) / lidar.max_depth
        u = torch.clamp(torch.cat([d, img[..., 1:]], dim=-1), 0, 1)
        B, H, W, C = u.shape
        return render_lib.colorize(u.permute(0, 3, 1, 2).reshape(B, C * H, W))

    def bev(x, colors=None):
        R, t = render_lib.make_Rt(pitch=np.pi / 4, yaw=np.pi / 4, z=0.6, device=x.device)
        d = lidar.revert_depth(lidar.denormalize(x)[..., 0:1])
        xyz = lidar.to_xyz(d) / lidar.max_depth
        B = xyz.shape[0]
        if colors is None:
            z_min, z_max = -2 / lidar.max_depth, 0.5 / lidar.max_depth
            z = torch.clamp((xyz[..., 2] - z_min) / (z_max - z_min), 0, 1)
            colors = render_lib.colorize(z, VIRIDIS).to(torch.float32) / 255.0
        img = 1 - render_lib.render_point_clouds(points=xyz.reshape(B, -1, 3), colors=1 - colors.reshape(B, -1, 3),
                                                 R=R, t=t, size=BEV_SIZE)
        return torch.clamp(img * 255, 0, 255).to(torch.uint8)

    rows = [range_images(x_in), bev(x_in), range_images(x_out)]
    if labels is None:
        rows.append(bev(x_out))
    else:
        colors = torch.from_numpy(rn.SEMANTICKITTI_RGB).to(labels.device)[labels]  # (B, H, W, 3) uint8
        rows += [colors, bev(x_out, colors.to(torch.float32) / 255.0)]
    rows = [r.cpu().numpy() for r in rows]
    width = max(r.shape[2] for r in rows)
    columns = [np.concatenate([_pad(r[i], width) for r in rows], axis=0) for i in range(BATCH)]
    gap = np.full((columns[0].shape[0], 8, 3), 255, np.uint8)
    return np.concatenate([part for c in columns for part in (c, gap)][:-1], axis=1)


def main(args: argparse.Namespace) -> int:
    world = parallel.init(args.device, mesh=args.mesh, batch_size=BATCH)
    try:
        return _run(args, world)
    finally:
        world.close()


def _run(args: argparse.Namespace, world: parallel.World) -> int:
    if args.few_step:
        apply_few_step_preset(args)
    device = world.device
    bf16 = args.bf16 or device.type == "cuda"
    ddpm, lidar, cfg = setup_model(args.ckpt, dtype=torch.bfloat16 if bf16 else None, device=device,
                                   width_merge_l1=args.latency_layout)
    lidar.data_format = "NHWC"
    H, W = cfg.data.resolution

    # ------------------------------------------------------------ test scan
    dataset = make_dataset(cfg.data.dataset, args.data_root or cfg.data.data_root, "test", cfg.data.projection)
    rng = np.random.default_rng(args.seed)
    sample_id = args.sample_id if args.sample_id >= 0 else int(rng.integers(0, len(dataset)))
    print(f"sample id: {sample_id}")
    planes = torch.from_numpy(dataset.planes(sample_id))[None].to(device)  # (1, Hd, Wd, 6)
    depth = lidar.normalize(lidar.convert_depth(planes[..., 4:5]))
    rflct = lidar.normalize(planes[..., 3:4])
    valid = planes[..., 5:6]
    x_orig = valid * torch.cat([depth, rflct], dim=-1) + (1 - valid) * -1.0
    x_orig = nearest_exact_resize(x_orig, (H, W))

    # --------------------------------------------------- corrupt, complete
    mask = torch.from_numpy(make_masks(rng, H, W)).to(device)
    x_in = mask * x_orig + (1 - mask) * -1.0
    rows = np.array_split(np.arange(BATCH), world.data_size)[world.data_index].tolist()
    x_rows = ddpm.repaint(known=x_in[rows], mask=mask[rows], num_steps=args.num_steps,
                          num_resample_steps=args.num_resample_steps, jump_length=args.jump_length,
                          seeds=rows, data_format="NHWC", progress=world.is_main, world=world)
    parts = parallel.gather_objects(world, x_rows.cpu())
    if not world.is_main:
        return 0
    # one part a data group: its width rank 0's (every width rank holds the whole rows)
    x_out = torch.clamp(torch.cat(parts[::world.width_size]).to(device), -1, 1)

    # ------------------------------------------- semantic labels (optional)
    labels = None
    if args.rangenet_tar:
        semseg, preprocess = rn.rangenet53(args.rangenet_tar, device=device)
        x = lidar.denormalize(x_out)
        d = lidar.revert_depth(x[..., 0:1])
        m = ((d > lidar.min_depth) & (d < lidar.max_depth)).to(torch.float32)
        inputs = torch.cat([d, lidar.to_xyz(d), x[..., 1:2]], dim=-1).permute(0, 3, 1, 2)
        with torch.inference_mode(), strict_fp32():
            labels = semseg(preprocess(inputs, m.permute(0, 3, 1, 2))).argmax(dim=1)  # (B, H, W)

    # --------------------------------------------------------------- figure
    save_path = f"completion_T-{args.num_steps:04d}_r-{args.num_resample_steps:04d}_j-{args.jump_length:04d}.png"
    render_lib.write_png(save_path, figure(lidar, x_in, x_out, labels))
    print(f'saved to "{save_path}"')
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--num_steps", type=int, default=32, help="RePaint outer steps")
    parser.add_argument("--num_resample_steps", type=int, default=16)
    parser.add_argument("--jump_length", type=int, default=1)
    parser.add_argument("--few_step", action="store_true", help="the 8 x 4 x 1 grid in bf16, W2C layout")
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute (implied on CUDA)")
    parser.add_argument("--latency_layout", action="store_true", help="W2C width-pair-merged level-1 layout")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sample_id", type=int, default=-1)
    parser.add_argument("--rangenet_tar", type=str, default=None)
    parser.add_argument("--mesh", type=str, default="", help="'N' or 'DxW': must multiply to the torchrun world size")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    sys.exit(main(parse_args()))
