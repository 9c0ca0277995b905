"""The port's data axis across processes, on the CPU: gloo ranks in
subprocesses against one process at the same global batch, for the trainer
(plain, accumulating, bf16 gradients, and on a (data, width) mesh), the
stop consensus, sample_and_save and evaluate; and the mesh checks, which
have no fallback.

Each rank is a subprocess with a deadline (``RANK_TIMEOUT_S``) and a
``init_process_group`` timeout of a minute, so a rank that hangs fails its
test instead of the run. The ranks meet through a file in the test's own
directory (no port to collide with another test). The one-rank reference
runs through the same script without a group, with the same thread count.
"""

import json
import math
import os
import signal
import subprocess
import sys
import time
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2dm_tpu import checkpoint as jax_checkpoint
from r2dm_tpu.config import TrainingConfig as JaxTrainingConfig
from r2dm_tpu.models.efficient_unet import EfficientUNet as JaxUNet
from r2dm_tpu.training import make_optimizer as jax_make_optimizer
from r2dm_tpu_torch import bench, completion_demo, evaluate, parallel, sample_and_save
from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch.checkpoint import load_checkpoint, write_checkpoint
from r2dm_tpu_torch.inference import build_model, model_coords
from r2dm_tpu_torch.train import main as train_main
from r2dm_tpu_torch.utils.weights import jax_from_state_dict

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 180
RUNNER = r'''
import datetime, json, os, runpy, sys
import torch

torch.set_num_threads(1)
rank, world, init_file, module = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
argv, prelude = json.loads(sys.argv[5]), sys.argv[6]
sys.modules["torch.utils.tensorboard"] = None  # the JSONL sink alone
exec(prelude, {})
if world > 1:
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    dist.init_process_group("gloo", init_method="file://" + init_file, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
try:
    if module == "-c":
        exec(argv[0], {"__name__": "__main__"})
    else:
        sys.argv = [module] + argv
        runpy.run_module(module, run_name="__main__", alter_sys=True)
except SystemExit as e:
    if e.code not in (0, None):
        raise
finally:
    if world > 1 and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
'''
TINY_FLAGS = [
    "--device", "cpu", "--data.dataset", "synthetic", "--data.projection", "spherical-256",
    "--data.resolution", "16,128", "--model.base_channels", "8", "--model.channel_multiplier", "1,2,2,2",
    "--model.num_residual_blocks", "1,1,1,1", "--model.gn_num_groups", "4", "--model.attn_num_heads", "2",
    "--training.batch_size_train", "8", "--training.lr_warmup_steps", "2", "--training.mixed_precision", "no",
    "--training.steps_save_image", "100000", "--training.steps_save_model", "100000",
]
LR = 1e-4  # the default lr of the runs below


class Ranks:
    """``world`` processes of ``module`` (``python -m``, or ``-c`` code),
    rank r with ``argvs[r]``, each writing its output to a log file."""

    def __init__(self, tmp_path, module, argvs, prelude="", cwds=None, env=None):
        self.dir = tmp_path / f"ranks-{uuid.uuid4().hex[:8]}"
        self.dir.mkdir()
        script = self.dir / "rank.py"
        script.write_text(RUNNER)
        world = len(argvs)
        env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", **(env or {})}
        self.logs = [self.dir / f"rank{r}.log" for r in range(world)]
        self.procs = []
        for r, argv in enumerate(argvs):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(script), str(r), str(world), str(self.dir / "rendezvous"), module,
                     json.dumps(argv), prelude],
                    cwd=str(cwds[r]) if cwds else str(REPO), env=env, stdout=log, stderr=subprocess.STDOUT,
                ))

    def wait(self) -> list[str]:
        """Every rank's output; fails if one exits non-zero or passes the
        deadline (then every rank is killed)."""
        deadline = time.time() + RANK_TIMEOUT_S
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            hung = [r for r, p in enumerate(self.procs) if p.poll() is None]
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = [log.read_text() for log in self.logs]
        assert not hung, f"ranks {hung} passed the {RANK_TIMEOUT_S} s deadline:\n" + "\n".join(o[-3000:] for o in outs)
        for r, p in enumerate(self.procs):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{outs[r][-4000:]}"
        return outs


def run(tmp_path, module, argvs, **kw) -> list[str]:
    return Ranks(tmp_path, module, argvs, **kw).wait()


def _leaves(node, path=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(node.float() if isinstance(node, torch.Tensor) else node)


def _same_checkpoint_trees(got, ref, rtol, atol_of):
    paths = [p for p, _ in _leaves(ref)]
    assert [p for p, _ in _leaves(got)] == paths
    for (path, a), (_, b) in zip(_leaves(got), _leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol_of(path, b), err_msg=path)


# --------------------------------------------------------------- training
# the tolerance of two ranks against one: fp32 sums in another order. The
# parameters get rtol 1e-5 and an atol of 1e-4 lr (Adam divides by sqrt(v):
# an entry whose gradient is within rounding of 0 moves by a rounding of its
# update, up to 1.3e-5 lr measured); the optimizer state rtol 1e-5 and an
# atol of 1e-5 of its leaf's largest value (3.9e-6 measured). With bf16
# gradients the ranks sum bf16 halves where one process rounds the whole
# gradient once, a bf16 step apart: the metrics and the optimizer state get
# 2e-2, and the parameters an atol of lr, since an entry within a bf16 step
# of 0 may flip the sign of its Adam update (0.036 lr measured). On a
# (data, width) mesh (1x2: two ranks, each 64 of the 128 columns; 2x2: four;
# accumulating too) the plain case's tolerances: the width ranks' gradient
# shares summed over the world in fp32, in another order.
CASES = {
    "plain": ([], 1e-5, 1e-4 * LR, 1e-5),
    "accumulating": (["--training.gradient_accumulation_steps", "2"], 1e-5, 1e-4 * LR, 1e-5),
    "grad_bf16": (["--training.mixed_precision", "bf16", "--training.grad_bf16", "true"], 2e-2, LR, 2e-2),
    "mesh_1x2": (["--training.mesh_shape", "1,2"], 1e-5, 1e-4 * LR, 1e-5),
    "mesh_2x2": (["--training.mesh_shape", "2,2"], 1e-5, 1e-4 * LR, 1e-5),
    "mesh_1x2_accumulating": (["--training.mesh_shape", "1,2", "--training.gradient_accumulation_steps", "2"], 1e-5,
                              1e-4 * LR, 1e-5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_train_as_one(tmp_path, case):
    """Two gloo ranks of ``python -m r2dm_tpu_torch.train`` at global batch
    8 (4 a rank) for 3 steps against one process at batch 8 (on a mesh, its
    D·W ranks): metrics.jsonl, the checkpoint's weights, EMA and optimizer
    state. Only rank 0 writes (the other ranks are given their own output
    directories, which stay absent), and the checkpoint has no ``module.``
    keys: the JAX trainer's resume path (restore_opt_state into its optax
    chain) reads it."""
    flags, rtol, atol_w, atol_opt = CASES[case]
    env = {"R2DM_SYNTH_SCANS": "8"}
    mesh = flags[:1] == ["--training.mesh_shape"]
    n = math.prod(int(v) for v in flags[1].split(",")) if mesh else 2

    def argv(out, flags=flags):
        return TINY_FLAGS + flags + ["--training.num_steps", "3", "--training.output_dir", str(out)]

    one, two = tmp_path / "one", tmp_path / "two"
    others = [tmp_path / f"rank{r}" for r in range(1, n)]
    run(tmp_path, "r2dm_tpu_torch.train", [argv(one, flags[2:] if mesh else flags)], env=env)
    outs = run(tmp_path, "r2dm_tpu_torch.train", [argv(two)] + [argv(o) for o in others], env=env)
    assert "done: 3 steps" in outs[0] and not any("done:" in o for o in outs[1:])
    assert not any(o.exists() for o in others)
    assert sorted(p.name for p in two.iterdir()) == sorted(p.name for p in one.iterdir())

    m1, m2 = (json.loads((d / "metrics.jsonl").read_text()) for d in (one, two))
    assert m1["step"] == m2["step"] == 1
    for k in ("loss", "grad_norm", "ema_decay", "lr"):
        assert m2[k] == pytest.approx(m1[k], rel=rtol, abs=1e-12), k
    c1, c2 = (load_checkpoint(str(d / "checkpoint.msgpack")) for d in (one, two))
    assert c1["global_step"] == c2["global_step"] == 3
    for key in ("weights", "ema_weights"):
        _same_checkpoint_trees(c2[key], c1[key], rtol, lambda path, b: atol_w)
    _same_checkpoint_trees(c2["opt_state"], c1["opt_state"], rtol,
                           lambda path, b: atol_opt * (float(np.abs(b).max()) if b.size else 0.0))

    # the JAX trainer's resume: weights in its params tree, opt_state into its chain
    tcfg = port_config.from_dict(c2["cfg"]).training
    net = JaxUNet(in_channels=2, resolution=(16, 128), base_channels=8, channel_multiplier=(1, 2, 2, 2),
                  num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2)
    params = jax.eval_shape(net.init, jax.random.key(0), jnp.zeros((1, 16, 128, 2)), jnp.zeros((1,)))["params"]
    assert jax.tree.structure(params) == jax.tree.structure(
        jax.tree.map(jnp.asarray, jax_checkpoint.load_checkpoint(str(two / "checkpoint.msgpack"))["weights"]["params"]))
    tx, _ = jax_make_optimizer(JaxTrainingConfig(gradient_accumulation_steps=tcfg.gradient_accumulation_steps))
    jck = jax_checkpoint.load_checkpoint(str(two / "checkpoint.msgpack"))
    jax_checkpoint.restore_opt_state(tx.init(jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), params)),
                                     jck["opt_state"])


def test_stop_flag_of_one_rank_stops_every_rank(tmp_path):
    """parallel.any_rank: rank 1 alone raises its flag from step 3 on, and
    both ranks return true first at step 3; the side group's gather and
    broadcast carry host objects in rank order."""
    code = (
        "import json\n"
        "from r2dm_tpu_torch import parallel\n"
        "world = parallel.init('cpu')\n"
        "stops = [parallel.any_rank(world, world.rank == 1 and i >= 3) for i in range(6)]\n"
        "got = parallel.gather_objects(world, {'rank': world.rank})\n"
        "seen = parallel.broadcast_object(world, 'from rank %d' % world.rank)\n"
        "print('RESULT', json.dumps([stops, got, seen, world.size, world.distributed]))\n"
    )
    outs = run(tmp_path, "-c", [[code], [code]])
    results = [json.loads(o.split("RESULT ")[1].splitlines()[0]) for o in outs]
    for r, (stops, got, seen, size, distributed) in enumerate(results):
        assert stops == [False, False, False, True, True, True], r
        assert (seen, size, distributed) == ("from rank 0", 2, True)
        assert got == ([{"rank": 0}, {"rank": 1}] if r == 0 else None)


def test_trainer_stops_every_rank_on_a_signal_to_one(tmp_path):
    """SIGTERM to rank 1 alone, once the first step is logged: both ranks
    stop at the same step boundary, exit 0, and rank 0 writes the
    checkpoint at that step."""
    out = tmp_path / "run"
    argv = TINY_FLAGS + ["--training.num_steps", "100000", "--training.output_dir", str(out)]
    ranks = Ranks(tmp_path, "r2dm_tpu_torch.train", [argv, argv], env={"R2DM_SYNTH_SCANS": "8"})
    deadline = time.time() + RANK_TIMEOUT_S
    while not (out / "metrics.jsonl").exists() and time.time() < deadline and all(
            p.poll() is None for p in ranks.procs):
        time.sleep(0.2)
    ranks.procs[1].send_signal(signal.SIGTERM)
    outs = ranks.wait()
    assert "received signal" in outs[1] and "received signal" not in outs[0]
    [line] = [ln for ln in outs[0].splitlines() if ln.startswith("preempted at step")]
    assert "on another rank" in line
    step = int(line.split()[3])
    assert load_checkpoint(str(out / "checkpoint.msgpack"))["global_step"] == step >= 1


# ---------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def tiny_msgpack(tmp_path_factory):
    """A msgpack checkpoint of a tiny net at 16x128 on the synthetic set,
    random weights from seed 0 (the eval tests' fixture)."""
    cfg = port_config.Config(
        data=port_config.DataConfig(dataset="synthetic", resolution=(16, 128), projection="spherical-256"),
        model=port_config.ModelConfig(base_channels=8, channel_multiplier=(1, 2, 2, 2),
                                      num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2),
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg, device="cpu")
    model.coords.copy_(torch.from_numpy(model_coords(cfg).transpose(2, 0, 1)[None].copy()))
    variables = jax_from_state_dict(model.state_dict())
    path = tmp_path_factory.mktemp("ckpt") / "tiny.msgpack"
    write_checkpoint(str(path), port_config.asdict(cfg), variables, ema_weights=variables, step=1)
    return str(path)


def test_two_ranks_sample_and_save_as_one(tmp_path, tiny_msgpack):
    """Seeds strided over two ranks: the same files as one process, each
    sample within atol 1e-6 (per-seed generators; the batches differ)."""

    def argv(out):
        return ["--ckpt", tiny_msgpack, "--output_dir", str(out), "--batch_size", "3", "--num_samples", "7",
                "--num_steps", "2", "--device", "cpu"]

    run(tmp_path, "r2dm_tpu_torch.sample_and_save", [argv(tmp_path / "one")])
    outs = run(tmp_path, "r2dm_tpu_torch.sample_and_save", [argv(tmp_path / "two")] * 2)
    assert "[4/4] saved" in outs[0] and "[3/3] saved" in outs[1]  # seeds 0, 2, 4, 6 and 1, 3, 5
    names = sorted(p.name for p in (tmp_path / "one").iterdir())
    assert names == [f"samples_{i:010d}.npz" for i in range(7)]
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == names
    for n in names:
        a, b = (np.load(tmp_path / d / n)["sample"] for d in ("one", "two"))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=n)


def test_two_ranks_evaluate_as_one(tmp_path, tiny_msgpack):
    """The extraction split over two ranks and gathered to rank 0: the same
    JSON as one process (1e-6 relative), written once; rank 1 writes no
    cache. 256 lidargen features keep the host's eigendecompositions short,
    as in tests/test_torch_port_eval.py."""
    samples = tmp_path / "samples"
    run(tmp_path, "r2dm_tpu_torch.sample_and_save", [["--ckpt", tiny_msgpack, "--output_dir", str(samples),
                                                     "--num_samples", "5", "--num_steps", "2", "--device", "cpu"]])
    prelude = "from r2dm_tpu_torch.metrics.extractor import rangenet as rn\nrn.NUM_FEATURES = 256\n"
    argv = ["--ckpt", tiny_msgpack, "--sample_dir", str(samples), "--batch_size", "2", "--allow_random_extractors",
            "--device", "cpu"]
    env = {"R2DM_SYNTH_SCANS": "4"}
    cwds = [tmp_path / d for d in ("one", "two0", "two1")]
    for d in cwds:
        d.mkdir()
    results = []
    for ranks in ([0], [1, 2]):
        run(tmp_path, "r2dm_tpu_torch.evaluate", [argv] * len(ranks), prelude=prelude, env=env,
            cwds=[cwds[i] for i in ranks])
        [path] = sorted(tmp_path.glob("samples_*.json"))
        results.append(json.loads(path.read_text()))
        path.unlink()
    assert [len(list(d.glob("real_set_torch_*.npz"))) for d in cwds] == [1, 1, 0]
    one, two = results
    assert one["info"] == two["info"] and (one["info"]["#real"], one["info"]["#fake"]) == (4, 5)
    for section in ("img", "pts", "bev"):
        assert sorted(one[section]) == sorted(two[section])
        for k, v in one[section].items():
            assert np.isfinite(v) and two[section][k] == pytest.approx(v, rel=1e-6, abs=1e-12), (section, k)


def test_two_ranks_complete_as_one(tmp_path, tiny_msgpack):
    """completion_demo's four mask rows split over two ranks (each row its
    own seed) and gathered to rank 0: the same figure, byte for byte, as
    one process; rank 1 writes none."""
    argv = ["--ckpt", tiny_msgpack, "--num_steps", "2", "--num_resample_steps", "2", "--device", "cpu"]
    cwds = [tmp_path / d for d in ("one", "two0", "two1")]
    for d in cwds:
        d.mkdir()
    env = {"R2DM_SYNTH_SCANS": "3"}
    run(tmp_path, "r2dm_tpu_torch.completion_demo", [argv], env=env, cwds=cwds[:1])
    run(tmp_path, "r2dm_tpu_torch.completion_demo", [argv] * 2, env=env, cwds=cwds[1:])
    name = "completion_T-0002_r-0002_j-0001.png"
    assert (cwds[1] / name).read_bytes() == (cwds[0] / name).read_bytes()
    assert not list(cwds[2].iterdir())


# ------------------------------------------------------------------ meshes
@pytest.mark.parametrize("spec,world,match", [
    ("2", 1, "--mesh 2 needs 2 devices, have 1"),
    ("1x2", 1, "--mesh 1x2 needs 2 devices, have 1"),
    ("2x4", 2, "--mesh 2x4 needs 8 devices, have 2"),
    ("x", 1, "positive ints"),
    ("0x1", 1, "positive ints"),
])
def test_parse_mesh_exits_with_its_reason(spec, world, match):
    with pytest.raises(SystemExit, match=match):
        parallel.parse_mesh(spec, world)


@pytest.mark.parametrize("spec,world,shape", [("", 3, None), ("0", 1, None), ("2", 2, (2,)), ("2x1", 2, (2, 1))])
def test_parse_mesh_takes_the_data_axis(spec, world, shape):
    assert parallel.parse_mesh(spec, world) == shape


@pytest.mark.parametrize("shape,match", [
    ((2,), "needs 2 devices, have 1"),
    ((1, 2), "needs 2 devices, have 1"),
    ((1, 1, 1), "expected"),
])
def test_mesh_shape_errors_stop_the_trainer(tmp_path, shape, match):
    """training.mesh_shape under parse_mesh's rules, a width axis too,
    before anything is built; None and (1,) / (1, 1) train on one
    process."""
    with pytest.raises(ValueError, match=match):
        parallel.check_mesh_shape(shape, 1)
    flags = TINY_FLAGS + ["--training.mesh_shape", ",".join(map(str, shape)),
                          "--training.output_dir", str(tmp_path / "run")]
    with pytest.raises(ValueError, match=match):
        train_main(flags)
    for ok in (None, (1,), (1, 1)):
        parallel.check_mesh_shape(ok, 1)


@pytest.mark.parametrize("module,argv,match", [
    ("sample_and_save", ["--output_dir", "x", "--mesh", "2"], "needs 2 devices, have 1"),
    ("evaluate", ["--sample_dir", "x", "--mesh", "1x2"], "needs 2 devices, have 1"),
    ("completion_demo", ["--mesh", "2x1"], "needs 2 devices, have 1"),
])
def test_cli_mesh_must_match_the_world(tiny_msgpack, module, argv, match):
    mod = {"sample_and_save": sample_and_save, "evaluate": evaluate, "completion_demo": completion_demo}[module]
    with pytest.raises(SystemExit, match=match):
        mod.main(mod.parse_args(["--ckpt", tiny_msgpack, *argv, "--device", "cpu"]))


def test_a_group_that_cannot_form_raises(monkeypatch):
    """torchrun's environment without a rendezvous address: no quiet
    single-process fallback."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        parallel.init("cpu")
    assert not torch.distributed.is_initialized()
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    world = parallel.init("cpu")
    assert (world.rank, world.size, world.distributed, world.device) == (0, 1, False, torch.device("cpu"))
    assert parallel.any_rank(world, True) and parallel.gather_objects(world, 3) == [3]


def test_bench_aggregates_the_ranks():
    """Rank 0's line with the ranks' summed img/s beside each rank's; one
    rank's line is unchanged."""
    r0 = {"value": 2.0, "mfu": 0.1, "mfu_all": 0.11, "ddim32_img_per_s": 10.0, "batch": 256}
    r1 = {"value": 1.5, "mfu": 0.08, "mfu_all": 0.09, "ddim32_img_per_s": 9.0, "batch": 256}
    assert bench.aggregate([r0]) is r0
    out = bench.aggregate([r0, r1])
    assert out["value"] == 3.5 and out["per_rank_img_per_s"] == [2.0, 1.5] and out["ranks"] == 2
    assert out["ddim32_img_per_s"] == 19.0 and out["per_rank_ddim32_img_per_s"] == [10.0, 9.0]
    assert out["mfu"] == pytest.approx(0.09) and out["batch"] == 256
    r1.pop("ddim32_img_per_s")
    assert bench.aggregate([r0, r1])["ddim32_img_per_s"] is None
