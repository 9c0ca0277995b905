"""The port's data pipeline and training entry point on the CPU: the
projection against the reference golden and the JAX package, the synthetic
dataset, the loader and the on-device preprocessing against the JAX
package's, and ``python -m r2dm_tpu_torch.train`` at a tiny size
(checkpoint, resume, image panels, SIGTERM)."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2dm_tpu.data import DataLoader as JaxDataLoader
from r2dm_tpu.data import SyntheticLiDAR as JaxSyntheticLiDAR
from r2dm_tpu.data import preprocess_batch as jax_preprocess_batch
from r2dm_tpu.data import project_points_numpy as jax_project_points
from r2dm_tpu.lidar import LiDARUtility as JaxLiDARUtility
from r2dm_tpu_torch import checkpoint
from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch.data import DataLoader, SyntheticLiDAR, make_dataset, preprocess_batch
from r2dm_tpu_torch.data import KITTI360, KITTIRaw
from r2dm_tpu_torch.data.projection import project_points, project_points_numpy
from r2dm_tpu_torch.lidar import LiDARUtility
from r2dm_tpu_torch.train import main as train_main
from r2dm_tpu_torch.train import step_generator

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
TINY_FLAGS = [
    "--data.dataset", "synthetic", "--data.projection", "spherical-256", "--data.resolution", "16,64",
    "--model.base_channels", "8", "--model.channel_multiplier", "1,2,2,2",
    "--model.num_residual_blocks", "1,1,1,1", "--model.gn_num_groups", "4", "--model.attn_num_heads", "2",
    "--model.coords_encoding", "None", "--training.batch_size_train", "4", "--training.batch_size_eval", "2",
    "--training.lr_warmup_steps", "2", "--training.mixed_precision", "no",
]


# ------------------------------------------------------ (g) projection, data
@pytest.mark.parametrize("key,unfold,H", [("spherical", False, 64), ("unfolding", True, 16)])
def test_projection_matches_golden_and_jax(key, unfold, H):
    """The C++ core to the golden (1e-6, as tests/test_data.py); its numpy
    plain version equal to the JAX package's."""
    g = np.load(GOLDEN / "projection.npz")
    pts = g["points" if key == "spherical" else "points_unfold"]
    ours = project_points(pts, scan_unfolding=unfold, H=H, W=256)
    np.testing.assert_allclose(ours, g[key], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(project_points_numpy(pts, scan_unfolding=unfold, H=H, W=256),
                                  jax_project_points(pts, scan_unfolding=unfold, H=H, W=256))


def test_synthetic_planes_match_jax(monkeypatch):
    ours = SyntheticLiDAR(num_scans=4, projection="spherical-256")
    ref = JaxSyntheticLiDAR(num_scans=4, projection="spherical-256")
    for i in (0, 3):
        # the JAX dataset may project through its native core, which gives
        # the numpy planes to 1e-6 (tests/test_data.py)
        np.testing.assert_allclose(ours.planes(i), ref.planes(i), rtol=1e-6, atol=1e-6)
        row = ours[i]
        assert row["depth"].shape == (1, 64, 256) and row["xyz"].shape == (3, 64, 256)
    monkeypatch.setenv("R2DM_SYNTH_SCANS", "5")
    assert len(make_dataset("synthetic", None, "train", "spherical-256")) == 5
    # the KITTI sets are ported (tests/test_torch_port_kitti.py); a root
    # without scans gives empty splits
    for name, cls in (("kitti_360", KITTI360), ("kitti_raw", KITTIRaw)):
        ds = make_dataset(name, "/nonexistent", "test", "spherical-1024")
        assert isinstance(ds, cls) and len(ds) == 0
    with pytest.raises(ValueError, match="unknown dataset"):
        make_dataset("nuscenes", None, "train", "spherical-1024")


# ------------------------------------------------------ (h) loader, preprocess
@pytest.mark.parametrize("process_index,process_count", [(0, 1), (1, 2)])
def test_loader_batches_and_preprocess_match_jax(process_index, process_count):
    ours = DataLoader(SyntheticLiDAR(num_scans=6, projection="spherical-256"), 2 * process_count, seed=3,
                      process_index=process_index, process_count=process_count)
    ref = JaxDataLoader(JaxSyntheticLiDAR(num_scans=6, projection="spherical-256"), 2 * process_count, seed=3,
                        process_index=process_index, process_count=process_count)
    lidar = LiDARUtility((16, 64), "log_depth", 1.45, 80.0, data_format="NHWC")
    jax_lidar = JaxLiDARUtility((16, 64), "log_depth", 1.45, 80.0, data_format="NHWC")
    it, jit = iter(ours), iter(ref)
    try:
        for _ in range(4):  # past the first epoch of 6 // (2 * count) batches
            b, r = next(it), next(jit)
            np.testing.assert_array_equal(b["sample_id"], r["sample_id"])
            for k in ("xyz", "reflectance", "depth", "mask"):
                np.testing.assert_allclose(b[k], r[k], rtol=1e-6, atol=1e-6, err_msg=k)
            x = preprocess_batch(lidar, {k: torch.from_numpy(v) for k, v in b.items()}, (16, 64))
            y = jax_preprocess_batch(jax_lidar, {k: jnp.asarray(v) for k, v in r.items()}, (16, 64))
            assert tuple(x.shape) == (2, 16, 64, 2)
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
    finally:
        it.close()
        jit.close()


def test_step_generator_depends_on_seed_and_step_only():
    a = torch.rand(4, generator=step_generator(0, 5, "cpu"))
    assert torch.equal(a, torch.rand(4, generator=step_generator(0, 5, "cpu")))
    assert not torch.equal(a, torch.rand(4, generator=step_generator(0, 6, "cpu")))
    assert not torch.equal(a, torch.rand(4, generator=step_generator(1, 5, "cpu")))


# ------------------------------------------------------------- (i) the CLI
@pytest.fixture
def no_tensorboard(monkeypatch):
    """The JSONL sink alone: importing TensorBoard costs seconds here."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("R2DM_SYNTH_SCANS", "8")


def test_train_cli_writes_checkpoint_panels_and_resumes(tmp_path, no_tensorboard):
    out = tmp_path / "run"
    flags = TINY_FLAGS + ["--device", "cpu", "--training.output_dir", str(out)]
    assert train_main(flags + ["--training.num_steps", "4", "--training.steps_save_image", "2",
                               "--training.steps_save_model", "3"]) == 0
    ck = checkpoint.load_checkpoint(str(out / "checkpoint.msgpack"))
    assert ck["global_step"] == 4 and int(ck["opt_state"]["1"]["0"]["count"]) == 4
    assert port_config.from_dict(ck["cfg"]).model.base_channels == 8
    lines = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1] and np.isfinite(lines[0]["loss"])
    assert {"loss", "grad_norm", "ema_decay", "lr", "steps_per_sec"} <= set(lines[0])
    images = sorted(p.name for p in (out / "images").iterdir())
    assert images == [f"{s:08d}_sample_{n}.png" for s in (2, 4) for n in ("bev", "depth", "mask", "reflectance")]
    assert json.loads((out / "training_config.json").read_text())["training"]["num_steps"] == 4

    mu = ck["opt_state"]["1"]["0"]["mu"]
    assert train_main(flags + ["--training.num_steps", "6", "--training.steps_save_image", "100",
                               "--training.resume", str(out / "checkpoint.msgpack")]) == 0
    ck2 = checkpoint.load_checkpoint(str(out / "checkpoint.msgpack"))
    assert ck2["global_step"] == 6 and int(ck2["opt_state"]["1"]["2"]["count"]) == 6
    k = ck2["opt_state"]["1"]["0"]["mu"]["in_conv"]["conv"]["kernel"]
    assert np.isfinite(k).all() and not np.array_equal(k, mu["in_conv"]["conv"]["kernel"])


def test_train_cli_checkpoints_and_exits_0_on_sigterm(tmp_path):
    """``python -m r2dm_tpu_torch.train`` in a subprocess: SIGTERM once the
    first step is logged; the step in flight finishes, the checkpoint is
    written and the exit code is 0."""
    out = tmp_path / "run"
    argv = TINY_FLAGS + ["--device", "cpu", "--training.output_dir", str(out), "--training.num_steps", "100000"]
    code = ("import runpy, sys\n"
            "sys.modules['torch.utils.tensorboard'] = None  # the JSONL sink alone\n"
            f"sys.argv = ['r2dm_tpu_torch.train'] + {argv!r}\n"
            "runpy.run_module('r2dm_tpu_torch.train', run_name='__main__', alter_sys=True)\n")
    env = {**os.environ, "R2DM_SYNTH_SCANS": "8", "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while not (out / "metrics.jsonl").exists() and proc.poll() is None and time.time() < deadline:
            time.sleep(0.2)
        assert proc.poll() is None, proc.communicate()[0]
        proc.send_signal(signal.SIGTERM)
        stdout, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stdout
    assert "preempted at step" in stdout, stdout
    ck = checkpoint.load_checkpoint(str(out / "checkpoint.msgpack"))
    assert 1 <= ck["global_step"] < 100000
