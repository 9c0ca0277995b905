"""Sample scans for evaluation and save each one.

    python -m r2dm_tpu_torch.sample_and_save --ckpt ckpt.msgpack --output_dir samples
    python -m r2dm_tpu_torch.sample_and_save --device cpu ...   # on the CPU
    torchrun --nproc_per_node N -m r2dm_tpu_torch.sample_and_save ...   # on N cards

The port's counterpart of the repo's ``sample_and_save.py`` (reference
sample_and_save.py): ``--num_samples`` scans, seed ``i`` for scan ``i``
(each scan's own generator, so a scan does not depend on the batch it ran
in), in batches of ``--batch_size`` through ``DDPM.sample``, which chunks a
batch over ``DDPM.MAX_BATCH_PIXELS``. Each scan is clipped, its depth
reverted to metres and back-projected, and written as
``samples_{seed:010d}.npz`` with ``sample`` (5, H, W) [depth, x, y, z,
reflectance], which ``evaluate`` of either package reads. On CUDA the
network computes in bfloat16, the kernels' type, so ``--bf16`` is implied.

Under ``torchrun`` the seeds are strided over the data axis, ``seeds[d::
D]``, as the JAX package strides them over processes
(sample_and_save.py:60-62); samples are per-seed deterministic, so no batch
is padded. ``--mesh`` ('N' or 'DxW') must multiply to the world size
(``parallel.parse_mesh``); with W > 1 the W ranks of a data group sample the
same seeds, each its columns of the scans (``DDPM.sample(world=)``), and
width rank 0 of each group writes the files. ``$R2DM_TPU_INT8`` (any non-empty value)
samples on the W8A8 serving lane (``models/layers.py::set_quant_conv``), as
the JAX package's does (sample_and_save.py:29-35); an int8 scan depends on
the batch it ran in (one activation scale a tensor).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch

from . import parallel
from .inference import setup_model
from .lidar import LiDARUtility
from .models.layers import set_quant_conv
from .utils import trace

MODES = ("ddpm", "ddim", "dpmpp_2m", "euler", "midpoint")


def postprocess(x: torch.Tensor, lidar_utils: LiDARUtility) -> torch.Tensor:
    """(B, C, H, W) samples in [-1, 1] -> (B, 5, H, W) [depth, x, y, z,
    reflectance] in metres (reference sample_and_save.py:52-57);
    ``lidar_utils`` in NCHW."""
    with trace.span("entry.points", device=x):
        x = lidar_utils.denormalize(torch.clamp(x, -1, 1))
        depth = lidar_utils.revert_depth(x[:, 0:1])
        return torch.cat([depth, lidar_utils.to_xyz(depth), x[:, 1:2]], dim=1)


def main(args: argparse.Namespace) -> int:
    world = parallel.init(args.device, mesh=args.mesh)
    try:
        return _run(args, world)
    finally:
        world.close()


def _run(args: argparse.Namespace, world: parallel.World) -> int:
    device = world.device
    bf16 = args.bf16 or device.type == "cuda"
    ddpm, lidar_utils, _ = setup_model(args.ckpt, dtype=torch.bfloat16 if bf16 else None, device=device)
    if os.environ.get("R2DM_TPU_INT8"):
        set_quant_conv(ddpm.model, "w8a8")
    save_dir = Path(args.output_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    seeds = np.arange(args.num_samples)[world.data_index::world.data_size]
    writes = world.width_rank == 0
    for lo in range(0, len(seeds), args.batch_size):
        batch_seeds = seeds[lo:lo + args.batch_size]
        x = ddpm.sample(batch_size=len(batch_seeds), num_steps=args.num_steps, seeds=batch_seeds.tolist(),
                        mode=args.mode, world=world)
        if writes:
            samples = postprocess(x, lidar_utils).cpu().numpy()
            for seed, sample in zip(batch_seeds, samples):
                np.savez_compressed(save_dir / f"samples_{seed:010d}.npz", sample=sample)
            print(f"[{lo + len(batch_seeds)}/{len(seeds)}] saved", flush=True)
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_samples", type=int, default=10_000)
    parser.add_argument("--num_steps", type=int, default=256)
    parser.add_argument("--mode", choices=MODES, default="ddpm")
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute (implied on CUDA)")
    parser.add_argument("--mesh", type=str, default="", help="'N' or 'DxW': must multiply to the torchrun world size")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    sys.exit(main(parse_args()))
