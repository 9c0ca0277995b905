"""The port's entry points on a LiDARGen RefineNet under the width axis, on
the CPU: ``sample_and_save --mesh 1x2`` and ``python -m
r2dm_tpu_torch.train --training.mesh_shape 1,2`` as two gloo ranks in
subprocesses (``test_torch_port_parallel.run``) against one process.

Both run in fp32, where a rank's InstanceNorm++ statistics (fp64 sums over
the width group) round otherwise than one process's (torch's fp32 mean and
variance): the forward moves by about 5e-6 relative L2
(``test_torch_port_refinenet_width.py``). A free-running chain's first step
(t = 1, 1/alpha = 1800, then clipped) amplifies that by its factor, and
max pooling sends each gradient to its window's maximum, so a near tie
there moves a gradient entry by far more than the rounding; the tolerances
below are set from those two, each with its measurement.
"""

import json

import numpy as np
import pytest
import torch
from test_torch_port_parallel import _leaves, _same_checkpoint_trees, run

from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch.checkpoint import load_checkpoint, write_checkpoint
from r2dm_tpu_torch.inference import build_model
from r2dm_tpu_torch.utils.weights import to_jax

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

FLAGS = ["--device", "cpu", "--data.dataset", "synthetic", "--data.projection", "spherical-256",
         "--data.resolution", "16,64", "--model.architecture", "refinenet", "--model.base_channels", "8",
         "--model.channel_multiplier", "1,2,2,2", "--training.batch_size_train", "4",
         "--training.lr_warmup_steps", "2", "--training.mixed_precision", "no",
         "--training.steps_save_image", "100000", "--training.steps_save_model", "100000"]
LR = 1e-4  # the trainer's default lr


@pytest.fixture(scope="module")
def refinenet_msgpack(tmp_path_factory):
    """A msgpack checkpoint of a tiny RefineNet at 16x64, the init of torch
    seed 0."""
    cfg = port_config.Config(
        data=port_config.DataConfig(dataset="synthetic", resolution=(16, 64), projection="spherical-256"),
        model=port_config.ModelConfig(architecture="refinenet", base_channels=8, channel_multiplier=(1, 2, 2, 2)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg, device="cpu")
    variables = to_jax(model.state_dict(), "refinenet")
    path = tmp_path_factory.mktemp("ckpt") / "refinenet.msgpack"
    write_checkpoint(str(path), port_config.asdict(cfg), variables, ema_weights=variables, step=1)
    return str(path)


def test_sample_and_save_1x2_writes_one_ranks_refinenet_files(tmp_path, refinenet_msgpack):
    """sample_and_save --mesh 1x2 of a RefineNet checkpoint on two ranks:
    the files one process writes (width rank 0 writes them); the samples
    within 1e-4 relative L2 of one process's (5.9e-5 measured) and 95 % of
    their pixels within 1e-4 m (98 %: the t = 1 step moves the rest)."""

    def argv(out, mesh):
        return ["--ckpt", refinenet_msgpack, "--output_dir", str(out), "--batch_size", "3", "--num_samples", "4",
                "--num_steps", "2", "--mode", "ddim", "--device", "cpu", "--mesh", mesh]

    run(tmp_path, "r2dm_tpu_torch.sample_and_save", [argv(tmp_path / "one", "1")])
    outs = run(tmp_path, "r2dm_tpu_torch.sample_and_save", [argv(tmp_path / "two", "1x2")] * 2)
    assert "[4/4] saved" in outs[0] and "saved" not in outs[1]
    names = sorted(p.name for p in (tmp_path / "one").iterdir())
    assert names == [f"samples_{i:010d}.npz" for i in range(4)]
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == names
    a, b = (np.stack([np.load(tmp_path / d / n)["sample"] for n in names]) for d in ("one", "two"))
    assert np.isfinite(b).all() and np.linalg.norm(b - a) <= 1e-4 * np.linalg.norm(a)
    assert (np.abs(b - a) <= 1e-4).mean() >= 0.95


def test_the_refinenet_trainer_under_1x2_trains_as_one_rank(tmp_path):
    """python -m r2dm_tpu_torch.train --model.architecture refinenet
    --training.mesh_shape 1,2 on two ranks, each 32 of the 64 columns, for
    2 steps at batch 4, against one process: the logged metrics to rtol
    1e-5; the checkpoint's weights and EMA to rtol 1e-5 with an atol of lr,
    and the weights' updates within 1e-2 relative L2 of one process's
    (1.3e-3 measured; the card's two-rank limit is 2e-2). Adam's first
    steps are lr * g / (|g| + 1e-8): an entry whose gradient is within
    fp32 noise of 0 moves by up to lr either way (the repo's grad_bf16
    case holds its weights at an atol of lr for that reason); here 99 % of
    the entries agree to rtol 1e-5, atol 1e-4 lr."""
    env = {"R2DM_SYNTH_SCANS": "8"}

    def argv(out, flags=()):
        return FLAGS + list(flags) + ["--training.num_steps", "2", "--training.output_dir", str(out)]

    one, two = tmp_path / "one", tmp_path / "two"
    run(tmp_path, "r2dm_tpu_torch.train", [argv(one)], env=env)
    mesh = ["--training.mesh_shape", "1,2"]
    outs = run(tmp_path, "r2dm_tpu_torch.train", [argv(two, mesh), argv(tmp_path / "rank1", mesh)], env=env)
    assert "done: 2 steps" in outs[0] and not (tmp_path / "rank1").exists()
    m1, m2 = (json.loads((d / "metrics.jsonl").read_text()) for d in (one, two))
    assert m1["step"] == m2["step"] == 1
    for k in ("loss", "grad_norm", "lr"):
        assert m2[k] == pytest.approx(m1[k], rel=1e-5, abs=1e-12), k
    c1, c2 = (load_checkpoint(str(d / "checkpoint.msgpack")) for d in (one, two))
    assert c1["global_step"] == c2["global_step"] == 2
    for key in ("weights", "ema_weights"):
        _same_checkpoint_trees(c2[key], c1[key], 1e-5, lambda path, b: LR)
    cfg = port_config.from_dict(c1["cfg"])
    with torch.random.fork_rng(devices=[]):  # the trainer's initial weights, from its seed
        torch.manual_seed(cfg.training.seed)
        w0 = to_jax(build_model(cfg, device="cpu").state_dict(), "refinenet")
    start, w1, w2 = (np.concatenate([b.ravel() for _, b in _leaves(t["params"])])
                     for t in (w0, c1["weights"], c2["weights"]))
    assert np.linalg.norm(w2 - w1) <= 1e-2 * np.linalg.norm(w1 - start)
