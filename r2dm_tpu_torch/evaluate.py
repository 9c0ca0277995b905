"""Evaluate generated scans against the real set: FRD, FPD, feature MMD and
BEV JSD/MMD.

    python -m r2dm_tpu_torch.evaluate --ckpt ckpt.msgpack --sample_dir samples \\
        --rangenet_tar darknet53.tar.gz --pointnet_ckpt cls_model_39.pth
    python -m r2dm_tpu_torch.evaluate --device cpu ...   # on the CPU
    torchrun --nproc_per_node N -m r2dm_tpu_torch.evaluate ...   # on N cards

The port's counterpart of the repo's ``evaluate.py`` (reference
evaluate.py): the lidargen depth gate (0.5, 63) m, RangeNet-53 "lidargen"
4096-d features (FRD), PointNet 1808-d features of the points / 80 m (FPD),
160 m / 100-bin BEV histograms, in float32 (TF32 off) on the device, in
sequential chunks of at most ``MAX_EXTRACT_PIXELS``. The real set's features
are cached in the working directory as ``real_set_torch_<dataset>_
<projection>_<H>x<W>_<split>_<extractors>.npz``: the ``torch`` tag keeps the
JAX package's pickles and this cache apart. The results go to stdout and to
``<sample_dir>_<timestamp>.json``, in the JAX package's layout. The feature
MMD draws its subsets from seed 0, so a run repeats (the JAX package draws
from numpy's global state).

The extractor weights are local files (nothing is downloaded): the official
bonnetal ``darknet53.tar.gz`` (``--rangenet_tar``) and SpareNet's
``cls_model_39.pth`` (``--pointnet_ckpt``). ``--allow_random_extractors``
runs the pipeline on random weights from fixed seeds (the metrics are then
not comparable to published numbers).

Under ``torchrun`` each data group extracts every D-th batch of
``--batch_size`` scans; the features and histograms are gathered to rank 0
over the gloo side group in their original order, and rank 0 alone computes
the distances, writes the JSON and the real-set cache (the counterpart of
the JAX package's data-parallel extraction, evaluate.py:94-107, which splits
the batch over the data axis only). ``--mesh`` ('N' or 'DxW') must multiply
to the world size; with W > 1 the W ranks of a data group extract the same
batches, and rank 0 keeps one copy of each.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import random
import sys
from pathlib import Path

import numpy as np
import torch

from . import parallel
from .data import make_dataset, nearest_exact_resize
from .inference import load_config
from .metrics import bev, distribution
from .metrics.extractor import pointnet as pn
from .metrics.extractor import rangenet as rn
from .metrics.extractor import strict_fp32

# lidargen constants (reference evaluate.py:21-23)
MAX_DEPTH = 63.0
MIN_DEPTH = 0.5
DATASET_MAX_DEPTH = 80.0
MAX_SCANS = 10_000  # generated scans read, and real BEV histograms compared

# Extraction chunking bound, in pixels (images x H x W) per chunk, stated as
# DDPM.MAX_BATCH_PIXELS is: the largest power of two of 64x1024 images n with
# n x m <= 0.7 x the card's memory, m the peak memory per image of one
# extraction (RangeNet-53 + PointNet + BEV; chip_smoke.py: the slope of
# torch.cuda.max_memory_allocated from b8 to b64).
MAX_EXTRACT_PIXELS = 128 * 64 * 1024


def load_sample(path: Path) -> np.ndarray:
    """(5, H, W) [depth, x, y, z, reflectance], from the ``.npz`` that
    ``sample_and_save`` of either package writes or the reference's ``.pth``."""
    if path.suffix == ".npz":
        with np.load(path) as f:
            return f["sample"]
    return torch.load(path, map_location="cpu", weights_only=True).numpy()


def gated(depth: np.ndarray) -> np.ndarray:
    return ((depth > MIN_DEPTH) & (depth < MAX_DEPTH)).astype(np.float32)


def _seeded(build, seed: int):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def build_extractors(args: argparse.Namespace, device):
    """extract(imgs (B, 5, H, W) [depth, x, y, z, reflectance], mask (B, 1,
    H, W)) float32 numpy -> (RangeNet features (B, 4096), PointNet features
    (B, 1808), BEV histograms (B, 100, 100)) numpy, computed on ``device``
    in chunks of at most ``MAX_EXTRACT_PIXELS``."""
    if args.rangenet_tar:
        img_net, pre = rn.rangenet53(args.rangenet_tar, device=device)
    elif args.allow_random_extractors:
        img_net, pre = _seeded(lambda: rn.rangenet53(None, device="cpu"), 0)
        img_net = img_net.to(device)
    else:
        raise SystemExit("need --rangenet_tar (official darknet53 tar.gz) or --allow_random_extractors")
    if args.pointnet_ckpt:
        pts_net = pn.pretrained_pointnet(args.pointnet_ckpt, device=device)
    elif args.allow_random_extractors:
        pts_net = _seeded(lambda: pn.PointNet1(k=16).eval(), 1).to(device)
    else:
        raise SystemExit("need --pointnet_ckpt or --allow_random_extractors")

    def extract(imgs: np.ndarray, mask: np.ndarray):
        B, _, H, W = imgs.shape
        chunk = max(1, MAX_EXTRACT_PIXELS // (H * W))
        outs = []
        for lo in range(0, B, chunk):
            x = torch.from_numpy(np.ascontiguousarray(imgs[lo:lo + chunk])).to(device)
            m = torch.from_numpy(np.ascontiguousarray(mask[lo:lo + chunk])).to(device)
            with torch.inference_mode(), strict_fp32():
                feats_img = img_net(pre(x, m), feature="lidargen")
                clouds = (x[:, 1:4] * m).reshape(len(x), 3, H * W)
                feats_pts = pts_net(clouds / DATASET_MAX_DEPTH)
                hists = bev.point_cloud_to_histogram(clouds.transpose(1, 2))
            outs.append([t.cpu().numpy() for t in (feats_img, feats_pts, hists)])
        return tuple(np.concatenate(parts) for parts in zip(*outs))

    return extract


def _ident(path, fallback: str) -> str:
    """The extractor's part of the cache key: random weights never share a
    cache with real ones."""
    if not path:
        return fallback
    digest = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:8]
    return f"{os.path.basename(path)}.{digest}"


def real_set_cache(args: argparse.Namespace, cfg) -> Path:
    ds_tag = cfg.data.dataset
    if ds_tag == "synthetic" and os.environ.get("R2DM_SYNTH_SCANS", "64") != "64":
        ds_tag += f"-{int(os.environ['R2DM_SYNTH_SCANS'])}"
    H, W = cfg.data.resolution
    ext = f"{_ident(args.rangenet_tar, 'randomRN')}-{_ident(args.pointnet_ckpt, 'randomPN')}"
    return Path(f"real_set_torch_{ds_tag}_{cfg.data.projection}_{H}x{W}_{args.dataset}_{ext}.npz")


def _features(extract, batches, world: parallel.World) -> dict:
    """The features of this data group's share of ``batches`` (a list of
    callables, each making one batch): every D-th from its data index. On
    rank 0 the whole set in the original order, gathered over the side
    group (one copy: width rank 0's of each group); None on the others."""
    keys = ("img_feats", "pts_feats", "bev_hists")
    mine = [(i, extract(*batches[i]())) for i in range(world.data_index, len(batches), world.data_size)]
    parts = parallel.gather_objects(world, mine)
    if parts is None:
        return None
    parts = parts[::world.width_size]
    ordered = [f for _, f in sorted((p for part in parts for p in part), key=lambda p: p[0])]
    return {k: np.concatenate([f[j] for f in ordered]) for j, k in enumerate(keys)}


def main(args: argparse.Namespace) -> int:
    world = parallel.init(args.device, mesh=args.mesh)
    try:
        return _run(args, world)
    finally:
        world.close()


def _run(args: argparse.Namespace, world: parallel.World) -> int:
    device = world.device
    cfg = load_config(args.ckpt)
    H, W = cfg.data.resolution
    extract = build_extractors(args, device)
    results = {"img": {}, "pts": {}, "bev": {}, "info": {"phase": args.dataset, "directory": args.sample_dir}}

    # ------------------------------------------------------------ real set
    cache = real_set_cache(args, cfg)
    if parallel.broadcast_object(world, cache.exists()):  # rank 0's answer, so every rank takes the same way
        real = None
        if world.is_main:
            print(f"found cached {cache}")
            with np.load(cache) as f:
                real = {k: f[k] for k in f.files}
    else:
        dataset = make_dataset(cfg.data.dataset, args.data_root or cfg.data.data_root, args.dataset,
                               cfg.data.projection)
        n = len(dataset)

        def real_batch(lo):
            planes = np.stack([dataset.planes(i) for i in range(lo, min(lo + args.batch_size, n))])
            planes = nearest_exact_resize(torch.from_numpy(planes), (H, W)).numpy()  # [x, y, z, r, d, m]
            depth = planes[..., 4:5]
            mask = planes[..., 5:6] * gated(depth)
            imgs = np.concatenate([depth, planes[..., 0:3], planes[..., 3:4]], axis=-1)
            print(f"real [{lo + len(planes)}/{n}]", flush=True)
            return imgs.transpose(0, 3, 1, 2), mask.transpose(0, 3, 1, 2)

        real = _features(extract, [lambda lo=lo: real_batch(lo) for lo in range(0, n, args.batch_size)], world)
        if world.is_main:
            tmp = cache.with_suffix(f".{os.getpid()}.tmp.npz")
            np.savez(tmp, **real)
            os.replace(tmp, cache)

    # ------------------------------------------------------------- gen set
    paths = sorted(Path(args.sample_dir).glob("*.npz")) or sorted(Path(args.sample_dir).glob("*.pth"))
    paths = paths[:MAX_SCANS]

    def gen_batch(lo):
        imgs = np.stack([load_sample(p) for p in paths[lo:lo + args.batch_size]]).astype(np.float32)
        mask = gated(imgs[:, 0:1])
        print(f"gen [{lo + len(imgs)}/{len(paths)}]", flush=True)
        return imgs * mask, mask

    gen = _features(extract, [lambda lo=lo: gen_batch(lo) for lo in range(0, len(paths), args.batch_size)], world)
    if not world.is_main:
        return 0
    results["info"]["#real"] = len(real["pts_feats"])
    results["info"]["#fake"] = len(gen["pts_feats"])

    # ------------------------------------------------------------- metrics
    if cfg.data.train_reflectance:
        results["img"]["frechet_distance"] = distribution.compute_frechet_distance(real["img_feats"], gen["img_feats"])
        results["img"]["squared_mmd"] = distribution.compute_squared_mmd(real["img_feats"], gen["img_feats"], seed=0)
    results["pts"]["frechet_distance"] = distribution.compute_frechet_distance(real["pts_feats"], gen["pts_feats"])
    results["pts"]["squared_mmd"] = distribution.compute_squared_mmd(real["pts_feats"], gen["pts_feats"], seed=0)
    # a fixed-seed subsample of the real histograms (reference evaluate.py:188-191)
    perm = list(range(len(real["bev_hists"])))
    random.Random(0).shuffle(perm)
    real_hists = torch.from_numpy(real["bev_hists"][perm[:MAX_SCANS]]).to(device)
    gen_hists = torch.from_numpy(gen["bev_hists"]).to(device)
    results["bev"]["jsd"] = bev.compute_jsd_2d(real_hists, gen_hists)
    results["bev"]["mmd"] = bev.compute_mmd_2d(real_hists, gen_hists)

    print(json.dumps(results, indent=2))
    stamp = datetime.datetime.now().strftime("%Y%m%dT%H%M%S")
    save_path = args.sample_dir.rstrip("/") + f"_{stamp}.json"
    with open(save_path, "w") as f:
        json.dump(results, f, indent=4)
    print("wrote", save_path)
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ckpt", type=str, required=True, help="the checkpoint whose config sets data and resolution")
    parser.add_argument("--sample_dir", type=str, required=True)
    parser.add_argument("--dataset", choices=["train", "test", "all"], default="all", help="the real split")
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--rangenet_tar", type=str, default=None)
    parser.add_argument("--pointnet_ckpt", type=str, default=None)
    parser.add_argument("--allow_random_extractors", action="store_true")
    parser.add_argument("--mesh", type=str, default="", help="'N' or 'DxW': must multiply to the torchrun world size")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    sys.exit(main(parse_args()))
