"""The port's KITTI data path on the CPU, against the JAX package and the
goldens: the split tables, the C++ projection core (built with g++ at first
use), KITTI-360 and KITTI Raw on fake ``.bin`` trees (file lists, planes,
and the memmap cache shared by both packages), and ``python -m
r2dm_tpu_torch.train`` on a fake KITTI-360 tree."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from r2dm_tpu.data import datasets as jax_datasets
from r2dm_tpu.data import kitti_splits as jax_splits
from r2dm_tpu.data import project_points_numpy as jax_project_points_numpy
from r2dm_tpu_torch.data import KITTI360, KITTIRaw, datasets, kitti_splits, make_dataset
from r2dm_tpu_torch.data.projection import project_points, project_points_numpy
from r2dm_tpu_torch.ops import build
from r2dm_tpu_torch.train import main as train_main

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
PROJ = "spherical-256"


def write_scan(path: Path, seed: int, n: int = 3000) -> None:
    """A fake Velodyne scan: float32 (x, y, z, reflectance) rows, ranges
    2-70 m inside the HDL-64E's +3..-25 degree elevations."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, n)
    el = np.deg2rad(rng.uniform(-24.0, 2.0, n))
    r = rng.uniform(2.0, 70.0, n)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el),
                    rng.uniform(0, 1, n)], axis=1).astype(np.float32)
    path.parent.mkdir(parents=True, exist_ok=True)
    pts.tofile(path)


@pytest.fixture(scope="module")
def kitti360_root(tmp_path_factory):
    """Sequences 0 and 2 (test) and 3 and 9 (train), two scans each, plus a
    file outside the pattern."""
    root = tmp_path_factory.mktemp("kitti360")
    for seq in (0, 2, 3, 9):
        for i in range(2):
            write_scan(root / f"2013_05_28_drive_{seq:04d}_sync" / "velodyne_points" / "data" / f"{i:010d}.bin",
                       seed=10 * seq + i)
    write_scan(root / "2013_05_28_drive_0001_sync" / "velodyne_points" / "data" / "0000000000.bin", seed=99)
    return root


# ----------------------------------------------------------- split tables
def test_split_tables_match_golden_and_jax():
    s = np.load(GOLDEN / "splits.npz")
    assert tuple(s["kitti360_train"]) == tuple(sorted(kitti_splits.KITTI360_SEQUENCE_SPLITS["train"]))
    assert tuple(s["kitti360_test"]) == tuple(sorted(kitti_splits.KITTI360_SEQUENCE_SPLITS["test"]))
    assert list(s["raw_test_drives"]) == kitti_splits.raw_test_drives()
    for key, val in zip(s["odometry_keys"], s["odometry_values"]):
        date, drive, start, end = kitti_splits.ODOMETRY_TO_RAW[int(key)]
        assert str(val) == str((kitti_splits.drive_name(date, drive), start, end)), key
    for name in ("KITTI360_SEQUENCE_SPLITS", "ODOMETRY_TO_RAW", "KITTIRAW_SEQUENCE_SPLITS", "RAW_CATEGORY_DRIVES"):
        assert getattr(kitti_splits, name) == getattr(jax_splits, name), name
    assert kitti_splits.raw_test_drives() == jax_splits.raw_test_drives()
    assert kitti_splits.raw_trainval_drives() == jax_splits.raw_trainval_drives()


# ------------------------------------------------------- the C++ core
@pytest.mark.parametrize("key,unfold,H", [("spherical", False, 64), ("unfolding", True, 16)])
def test_native_core_matches_numpy_and_golden(key, unfold, H):
    """rtol = atol = 1e-6, as tests/test_data.py holds the JAX package's
    core; the numpy version equals the JAX package's bit for bit."""
    g = np.load(GOLDEN / "projection.npz")
    pts = g["points" if key == "spherical" else "points_unfold"]
    native = project_points(pts, scan_unfolding=unfold, H=H, W=256)
    plain = project_points_numpy(pts, scan_unfolding=unfold, H=H, W=256)
    np.testing.assert_allclose(native, g[key], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(native, plain, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(plain, jax_project_points_numpy(pts, scan_unfolding=unfold, H=H, W=256))


def test_native_core_build_failure_raises(tmp_path, monkeypatch):
    """No g++, or a source g++ refuses: a RuntimeError, never a silent
    fallback to numpy."""
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        project_points(np.zeros((4, 4), np.float32), H=4, W=8)
    monkeypatch.undo()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "projection.cc").write_text("this is not C++\n")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "CSRC", csrc)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        project_points(np.zeros((4, 4), np.float32), H=4, W=8)
    with pytest.raises(ValueError, match="points must be"):
        project_points(np.zeros((4, 3), np.float32), H=4, W=8)


# ------------------------------------------------------------ KITTI sets
@pytest.mark.parametrize("split", ["train", "test", "all"])
def test_kitti360_files_and_planes_match_jax(kitti360_root, split):
    ours = KITTI360(str(kitti360_root), split=split, projection=PROJ)
    ref = jax_datasets.KITTI360(str(kitti360_root), split=split, projection=PROJ)
    assert ours.file_paths == ref.file_paths and len(ours) == {"train": 4, "test": 4, "all": 8}[split]
    assert all(Path(p).name.endswith(".bin") and "_0001_sync" not in p for p in ours.file_paths)
    for i in (0, len(ours) - 1):
        np.testing.assert_allclose(ours.planes(i), ref.planes(i), rtol=1e-6, atol=1e-6)
        row = ours[i]
        assert row["xyz"].shape == (3, 64, 256) and set(np.unique(row["mask"])) <= {0.0, 1.0}


def test_kittiraw_files_and_planes_match_jax(tmp_path):
    """Train and validation list the odometry frames (sequence 3 skipped),
    test globs the city/road/residential drives outside them."""
    drive = kitti_splits.raw_test_drives()[0]
    for i in range(2):
        write_scan(tmp_path / drive[:10] / drive / "velodyne_points" / "data" / f"{i:010d}.bin", seed=i)
    date, num, start, _ = kitti_splits.ODOMETRY_TO_RAW[8]
    val_first = tmp_path / date / kitti_splits.drive_name(date, num) / "velodyne_points" / "data" / f"{start:010d}.bin"
    write_scan(val_first, seed=7)
    for split in ("train", "validation", "test"):
        ours = KITTIRaw(str(tmp_path), split=split, projection=PROJ)
        ref = jax_datasets.KITTIRaw(str(tmp_path), split=split, projection=PROJ)
        assert ours.file_paths == ref.file_paths, split
    train = KITTIRaw(str(tmp_path), split="train", projection=PROJ)
    assert not any("2011_09_26_drive_0067" in p for p in train.file_paths)
    assert len(train) == sum(e - s + 1 for q, (_, _, s, e) in kitti_splits.ODOMETRY_TO_RAW.items() if q not in (3, 8))
    val = KITTIRaw(str(tmp_path), split="validation", projection=PROJ)
    assert val.file_paths[0] == str(val_first)
    np.testing.assert_allclose(val.planes(0), jax_datasets.KITTIRaw(str(tmp_path), "validation", PROJ).planes(0),
                               rtol=1e-6, atol=1e-6)
    test = KITTIRaw(str(tmp_path), split="test", projection=PROJ)
    assert len(test) == 2
    with pytest.raises(ValueError, match="unknown split"):
        KITTIRaw(str(tmp_path), split="all")
    assert isinstance(make_dataset("kitti_raw", str(tmp_path), "test", PROJ), KITTIRaw)


def test_projection_cache_is_shared_with_the_jax_package(kitti360_root, tmp_path, monkeypatch):
    """A cache either package builds has the same name and layout, and the
    other package reads it without projecting a scan."""
    cache = tmp_path / "cache"
    ours = make_dataset("kitti_360", str(kitti360_root), "test", PROJ, cache_dir=str(cache))
    built = sorted(p.name for p in cache.iterdir())
    assert built == [ours.cache_path(str(cache), PROJ, "kitti360-test").name] and built[0].startswith("kitti360-test-")

    def no_projection(self, fp):
        raise AssertionError(f"projected {fp} instead of reading the cache")

    monkeypatch.setattr(jax_datasets.RangeImageDataset, "project_file", no_projection)
    ref = jax_datasets.KITTI360(str(kitti360_root), split="test", projection=PROJ, cache_dir=str(cache))
    for i in range(len(ours)):
        np.testing.assert_array_equal(ref.planes(i), ours.planes(i))
    monkeypatch.undo()

    # the other way: the JAX package builds, the port reads
    ref = jax_datasets.KITTI360(str(kitti360_root), split="train", projection=PROJ, cache_dir=str(cache))
    monkeypatch.setattr(datasets.RangeImageDataset, "project_file", no_projection)
    ours = KITTI360(str(kitti360_root), split="train", projection=PROJ, cache_dir=str(cache))
    assert len(list(cache.iterdir())) == 2
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours.planes(i), ref.planes(i))


def test_train_cli_on_a_kitti360_tree(kitti360_root, tmp_path, monkeypatch):
    """``python -m r2dm_tpu_torch.train --device cpu`` for 2 steps of a tiny
    net on the fake tree: the projection cache lands in <output_dir>/cache."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the JSONL sink alone
    out = tmp_path / "run"
    flags = [
        "--device", "cpu", "--data.dataset", "kitti_360", "--data.data_root", str(kitti360_root),
        "--data.projection", PROJ, "--data.resolution", "16,64", "--model.base_channels", "8",
        "--model.channel_multiplier", "1,2,2,2", "--model.num_residual_blocks", "1,1,1,1",
        "--model.gn_num_groups", "4", "--model.attn_num_heads", "2", "--model.coords_encoding", "None",
        "--training.batch_size_train", "2", "--training.num_steps", "2", "--training.steps_save_image", "100",
        "--training.mixed_precision", "no", "--training.output_dir", str(out),
    ]
    assert train_main(flags) == 0
    assert [p.name.split("-")[:3] for p in (out / "cache").iterdir()] == [["kitti360", "train", "spherical"]]
    lines = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert lines[0]["step"] == 1 and np.isfinite(lines[0]["loss"])
    assert (out / "checkpoint.msgpack").exists()
