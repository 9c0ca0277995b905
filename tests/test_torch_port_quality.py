"""The port's relative-quality protocols, ``python -m r2dm_tpu_torch.
{ddim,flow}_quality_check``, against ``tools/{ddim,flow}_quality_check.sh``.

- the knobs (spec lists, sizes, reflow arguments, the summary's key) read
  out of the scripts' text;
- the train gate on the smallest CPU network, its legs run in this process:
  a checkpoint preempted short of a matching target is resumed (and one
  that stays short fails with the scripts' message), one of another target
  is deleted and trained again, a ``.train_done`` one is left alone (the
  counterpart of ``tests/test_quality_scripts.py``, which runs the scripts);
- the summary over hand-written ``meta.json`` and eval JSONs in
  ``evaluate``'s layout, and its guards;
- the caches: a workdir whose results match reruns no leg; a sample leg
  whose ``meta.json`` differs is deleted and sampled again, and an eval
  older than its ``meta.json`` is evaluated again;
- the device check, and ``run_leg``'s process (cwd, ``PYTHONPATH``, exit
  code).

The end-to-end runs in smoke mode are marked slow: each protocol makes 3 or
5 ``evaluate`` runs, and each of those pays two 4096^2 ``eigh`` on the CPU.
"""

import json
import os
import re
import runpy
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2dm_tpu.metrics import bev as jax_bev
from r2dm_tpu_torch import checkpoint, ddim_quality_check, flow_quality_check, quality
from r2dm_tpu_torch.metrics import bev
from r2dm_tpu_torch.train import main as train_main

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PROTOCOLS = {"ddim": (ddim_quality_check, "R2DM_DDIMQ_SMOKE"), "flow": (flow_quality_check, "R2DM_FLOWQ_SMOKE")}
KNOBS = ("R2DM_DDIMQ_SMOKE", "R2DM_FLOWQ_SMOKE", "R2DM_QUALITY_TRAIN_STEPS", "R2DM_QUALITY_TRAIN_ARGS",
         "R2DM_QUALITY_TRAIN_ONLY", "R2DM_QUALITY_REFLOW_STEPS")
# the smallest CPU network of the port's trainer tests, appended to the
# full-size flags through the scripts' own knob
TINY_ARGS = ("--data.projection spherical-256 --data.resolution 16,64 --model.base_channels 8 "
             "--model.channel_multiplier 1,2,2,2 --model.num_residual_blocks 1,1,1,1 --model.gn_num_groups 4 "
             "--model.attn_num_heads 2 --model.coords_encoding None --training.batch_size_train 4 "
             "--training.mixed_precision no")
ROWS = ["img.frechet_distance", "img.squared_mmd", "pts.frechet_distance", "pts.squared_mmd", "bev.jsd", "bev.mmd"]


def tags(name: str, smoke: bool = False) -> list:
    if name == "ddim":
        return [f"{mode}{steps}" for steps, mode in (ddim_quality_check.SMOKE_SPECS if smoke
                                                     else ddim_quality_check.SPECS)]
    return [tag for _, tag, _ in flow_quality_check.LEGS]


def legs(name: str) -> dict:
    """tag -> (steps, mode, checkpoint file name) of the full-size legs."""
    if name == "ddim":
        return {f"{mode}{steps}": (steps, mode, "ckpt/checkpoint.msgpack") for steps, mode in ddim_quality_check.SPECS}
    files = {"teacher": "ckpt/checkpoint.msgpack", "reflow": "reflowed.msgpack"}
    return {tag: (steps, "euler", files[which]) for which, tag, steps in flow_quality_check.LEGS}


@pytest.fixture
def env(monkeypatch):
    """No knob from the caller's environment; the trainer's JSONL sink alone
    (importing TensorBoard costs seconds here); a small synthetic set."""
    for var in KNOBS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("R2DM_SYNTH_SCANS", "8")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return monkeypatch


def in_process(calls: list):
    """A leg runner: ``python -m r2dm_tpu_torch.<module>`` in this process,
    in the leg's working directory; records (module, argv)."""
    def run(module, argv, cwd):
        calls.append((module, list(argv)))
        saved_cwd, saved_argv = os.getcwd(), sys.argv
        sys.argv = [module, *argv]
        try:
            os.chdir(cwd)
            with warnings.catch_warnings():  # the module is imported already; runpy runs it anew as __main__
                warnings.filterwarnings("ignore", "'r2dm_tpu_torch", RuntimeWarning)
                runpy.run_module(f"r2dm_tpu_torch.{module}", run_name="__main__", alter_sys=True)
        except SystemExit as e:
            if e.code not in (0, None):
                raise
        finally:
            os.chdir(saved_cwd)
            sys.argv = saved_argv
    return run


def flag(argv: list, name: str):
    return argv[argv.index(name) + 1] if name in argv else None


# ----------------------------------------------------------------- knobs
def _script(name: str) -> str:
    return (REPO / "tools" / f"{name}_quality_check.sh").read_text()


def _words(text: str) -> list:
    return text.replace("\\\n", " ").split()


def _size(s: quality.Sizes) -> tuple:
    return s.train_steps, s.train_batch, s.sample_batch


def test_knobs_are_the_scripts(env):
    ddim, flow = _script("ddim"), _script("flow")
    for text, module in ((ddim, ddim_quality_check), (flow, flow_quality_check)):
        assert re.search(r'json\.dumps\(\{"(\w+)": rows\}', text).group(1) == module.KEY
        smoke_sizes, full_sizes = re.findall(r"TRAIN_STEPS=(\S+); TRAIN_BATCH=(\d+); SAMPLE_BATCH=(\d+)", text)
        assert tuple(map(int, smoke_sizes)) == _size(quality.sizes(True))
        assert full_sizes[0] == "${R2DM_QUALITY_TRAIN_STEPS:-600}"
        assert (600, int(full_sizes[1]), int(full_sizes[2])) == _size(quality.sizes(False))
        small = re.search(r'SMALL_ARGS="([^"]*)"', text).group(1)
        assert _words(small) == list(quality.sizes(True).small_args) == quality.SMALL_ARGS
    specs = [[(int(s), m) for s, m in (leg.split() for leg in spec.split("|"))]
             for spec in re.findall(r'SPECS="([^"]*)"', ddim)]
    assert specs == [ddim_quality_check.SMOKE_SPECS, ddim_quality_check.SPECS]
    legs_sh = re.findall(r'^sample_eval "\$WORK/(ckpt/checkpoint|reflowed)\.msgpack" (\w+) (\d+)$', flow, re.M)
    assert [({"ckpt/checkpoint": "teacher", "reflowed": "reflow"}[c], t, int(s)) for c, t, s in legs_sh] == \
        flow_quality_check.LEGS
    smoke_reflow, full_reflow = re.findall(r'REFLOW_ARGS="([^"]*)"', flow)
    assert _words(smoke_reflow) == flow_quality_check.reflow_args(True)
    assert " ".join(_words(full_reflow)) == " ".join(flow_quality_check.reflow_args(False)[:-1]) + \
        " ${R2DM_QUALITY_REFLOW_STEPS:-1000}"


def test_full_size_knobs_read_the_environment(env):
    assert quality.sizes(False).train_steps == 600 and flow_quality_check.reflow_args(False)[-1] == "1000"
    env.setenv("R2DM_QUALITY_TRAIN_STEPS", "8")
    env.setenv("R2DM_QUALITY_REFLOW_STEPS", "9")
    assert quality.sizes(False).train_steps == 8 and flow_quality_check.reflow_args(False)[-1] == "9"
    assert quality.sizes(True).train_steps == 60  # smoke mode keeps its size, as the scripts do


# ------------------------------------------------------------ train gate
def _set_target(ckpt_dir: Path, steps: int) -> None:
    path = ckpt_dir / "training_config.json"
    cfg = json.loads(path.read_text())
    cfg["training"]["num_steps"] = steps
    path.write_text(json.dumps(cfg))


def _step(ckpt_dir: Path) -> int:
    return checkpoint.load_checkpoint(str(ckpt_dir / "checkpoint.msgpack"))["global_step"]


@pytest.mark.parametrize("name", ["ddim", "flow"])
def test_train_gate_resumes_retrains_and_keeps(tmp_path, env, capsys, name):
    module, _ = PROTOCOLS[name]
    work = tmp_path / "work"
    ckpt_dir = work / "ckpt"
    timestep = ["--diffusion.timestep_type", "flow"] if name == "flow" else []
    env.setenv("R2DM_QUALITY_TRAIN_STEPS", "4")
    env.setenv("R2DM_QUALITY_TRAIN_ARGS", TINY_ARGS)
    env.setenv("R2DM_QUALITY_TRAIN_ONLY", "1")
    argv = [str(work), "8", "--device", "cpu"]

    # a 4-step run preempted at step 2: a complete 2-step run whose stored
    # target is then 4, the state a graceful preemption leaves
    assert train_main(["--device", "cpu", "--data.dataset", "synthetic", *timestep, *TINY_ARGS.split(),
                       "--training.num_steps", "2", "--training.output_dir", str(ckpt_dir)]) == 0
    _set_target(ckpt_dir, 4)
    capsys.readouterr()

    # a leg that leaves the checkpoint short fails with the scripts' message
    noop = []
    with pytest.raises(SystemExit) as e:
        module.main(argv, run=lambda m, a, c: noop.append((m, a)))
    out, err = capsys.readouterr()
    assert e.value.code == 1 and "checkpoint preempted before step 4; rerun to retrain" in err
    assert "resuming preempted training from" in out and [m for m, _ in noop] == ["train"]
    assert not (ckpt_dir / ".train_done").exists() and _step(ckpt_dir) == 2

    # resumed: 2 -> 4, the trainer's flags and the protocol's device
    calls = []
    assert module.main(argv, run=in_process(calls)) == 0
    out = capsys.readouterr().out
    assert f"resuming preempted training from {ckpt_dir / 'checkpoint.msgpack'}" in out
    assert f"train gate done (R2DM_QUALITY_TRAIN_ONLY=1): {ckpt_dir}" in out
    [(leg, a)] = calls
    assert leg == "train" and flag(a, "--training.resume") == str(ckpt_dir / "checkpoint.msgpack")
    assert (flag(a, "--training.num_steps"), flag(a, "--training.steps_save_model"), flag(a, "--device"),
            flag(a, "--diffusion.timestep_type")) == ("4", "4", "cpu", "flow" if name == "flow" else None)
    ck = checkpoint.load_checkpoint(str(ckpt_dir / "checkpoint.msgpack"))
    assert ck["global_step"] == 4 and int(ck["opt_state"]["1"]["0"]["count"]) == 4  # AdamW continued
    assert (ckpt_dir / ".train_done").exists()

    # another stored target: deleted and trained from scratch
    (ckpt_dir / ".train_done").unlink()
    _set_target(ckpt_dir, 999)
    (ckpt_dir / "left_by_the_old_run").touch()
    calls.clear()
    assert module.main(argv, run=in_process(calls)) == 0
    out = capsys.readouterr().out
    assert "resuming preempted training" not in out and [m for m, _ in calls] == ["train"]
    assert flag(calls[0][1], "--training.resume") is None
    assert not (ckpt_dir / "left_by_the_old_run").exists()
    assert _step(ckpt_dir) == 4 and (ckpt_dir / ".train_done").exists()
    assert json.loads((ckpt_dir / "training_config.json").read_text())["training"]["num_steps"] == 4

    # .train_done: the checkpoint is not touched, whatever the target
    env.setenv("R2DM_QUALITY_TRAIN_STEPS", "5")
    before = {p.name: p.stat().st_mtime_ns for p in ckpt_dir.iterdir()}
    calls.clear()
    assert module.main(argv, run=in_process(calls)) == 0
    assert calls == [] and "resuming" not in capsys.readouterr().out
    assert {p.name: p.stat().st_mtime_ns for p in ckpt_dir.iterdir()} == before and _step(ckpt_dir) == 4


# --------------------------------------------------------------- summary
def _eval_json(tag: str, fake: int, value: float) -> dict:
    """An eval result in ``evaluate``'s layout."""
    return {"img": {"frechet_distance": value, "squared_mmd": value / 10},
            "pts": {"frechet_distance": value / 100, "squared_mmd": value / 1000},
            "bev": {"jsd": value / 1e4, "mmd": value / 1e5},
            "info": {"phase": "all", "directory": f"samples_{tag}", "#real": 8, "#fake": fake}}


def _results(work: Path, name: str, n: int, t_meta: float = 1.0e9) -> dict:
    """For every full-size leg of ``name``: its sample directory with a
    matching meta.json (mtime ``t_meta``), one file, and an eval JSON a
    second newer; returns tag -> the value the JSON holds."""
    values = {}
    for i, (tag, (steps, mode, _)) in enumerate(legs(name).items()):
        out = work / f"samples_{tag}"
        out.mkdir(parents=True)
        (out / "samples_0000000000.npz").write_bytes(b"")
        meta = out / "meta.json"
        meta.write_text(json.dumps({"n": n, "steps": steps, "mode": mode}))
        os.utime(meta, (t_meta, t_meta))
        values[tag] = 1000.0 + 123.456789 * i
        path = work / f"samples_{tag}_20260101T000000.json"
        path.write_text(json.dumps(_eval_json(tag, n, values[tag])))
        os.utime(path, (t_meta + 1, t_meta + 1))
    return values


def _expected_table(name: str, values: dict) -> dict:
    module, _ = PROTOCOLS[name]
    scale = {"img.frechet_distance": 1, "img.squared_mmd": 10, "pts.frechet_distance": 100,
             "pts.squared_mmd": 1000, "bev.jsd": 1e4, "bev.mmd": 1e5}
    return {module.KEY: {row: {t: round(values[t] / scale[row], 4) for t in tags(name)} for row in ROWS}}


@pytest.mark.parametrize("name", ["ddim", "flow"])
def test_summary_has_the_scripts_key_tags_and_rows(tmp_path, name):
    values = _results(tmp_path, name, 8)
    # an older result of each leg, from before its samples: not read
    for tag in tags(name):
        old = tmp_path / f"samples_{tag}_20250101T000000.json"
        old.write_text(json.dumps(_eval_json(tag, 8, -1.0)))
        os.utime(old, (1.0e9 - 5, 1.0e9 - 5))
    table = quality.summary(str(tmp_path), 8, tags(name), PROTOCOLS[name][0].KEY)
    assert table == _expected_table(name, values)
    assert list(table[PROTOCOLS[name][0].KEY]) == ROWS
    assert [list(row) for row in table[PROTOCOLS[name][0].KEY].values()] == [tags(name)] * len(ROWS)


@pytest.mark.parametrize("case", ["stale", "fake_count", "meta_n", "missing"])
def test_summary_raises_on_stale_or_mismatched_results(tmp_path, case):
    _results(tmp_path, "ddim", 8)
    tag = "ddim32"
    path = tmp_path / f"samples_{tag}_20260101T000000.json"
    if case == "stale":  # the result predates its samples' meta.json
        os.utime(path, (1.0e9 - 1, 1.0e9 - 1))
        match = "all predate its meta.json"
    elif case == "fake_count":
        path.write_text(json.dumps(_eval_json(tag, 7, 1.0)))
        os.utime(path, (1.0e9 + 1, 1.0e9 + 1))
        match = "eval ran on 7 samples, meta says 8"
    elif case == "meta_n":
        (tmp_path / f"samples_{tag}" / "meta.json").write_text(json.dumps({"n": 16, "steps": 32, "mode": "ddim"}))
        match = "is not of 8 samples"
    else:
        path.unlink()
        match = "no eval json for ddim32"
    with pytest.raises(quality.StaleResult, match=match):
        quality.summary(str(tmp_path), 8, tags("ddim"), ddim_quality_check.KEY)


# ---------------------------------------------------------------- caches
def _cached_workdir(work: Path, name: str, n: int) -> dict:
    (work / "ckpt").mkdir(parents=True)
    (work / "ckpt" / "checkpoint.msgpack").write_bytes(b"")
    (work / "ckpt" / ".train_done").touch()
    if name == "flow":
        (work / "reflowed.msgpack").write_bytes(b"")
    return _results(work, name, n)


@pytest.mark.parametrize("name", ["ddim", "flow"])
def test_matching_results_rerun_no_leg(tmp_path, env, capsys, name):
    module, _ = PROTOCOLS[name]
    values = _cached_workdir(tmp_path, name, 8)
    before = {str(p): p.stat().st_mtime_ns for p in tmp_path.rglob("*")}
    calls = []
    assert module.main([str(tmp_path), "8", "--device", "cpu"], run=lambda m, a, c: calls.append(m)) == 0
    out = capsys.readouterr().out
    assert calls == [] and "leg " not in out
    assert json.loads(out) == _expected_table(name, values)
    assert {str(p): p.stat().st_mtime_ns for p in tmp_path.rglob("*")} == before


def _fake_legs(work: Path, calls: list, n: int):
    """A leg runner that writes what the legs would: ``n`` sample files, an
    eval JSON of ``n`` scans stamped after every other."""
    def run(module, argv, cwd):
        calls.append((module, list(argv), cwd))
        if module == "sample_and_save":
            out = Path(flag(argv, "--output_dir"))
            out.mkdir(parents=True)
            for i in range(n):
                (out / f"samples_{i:010d}.npz").write_bytes(b"")
        elif module == "evaluate":
            tag = Path(flag(argv, "--sample_dir")).name[len("samples_"):]
            (work / f"samples_{tag}_20990101T000000.json").write_text(json.dumps(_eval_json(tag, n, 5.0)))
    return run


@pytest.mark.parametrize("case", ["meta_differs", "eval_older"])
@pytest.mark.parametrize("name", ["ddim", "flow"])
def test_a_leg_whose_cache_differs_runs_again(tmp_path, env, capsys, name, case):
    """meta_differs: the second leg's meta.json is of other steps, so its
    directory goes and it is sampled and evaluated again; eval_older: its
    only result predates its meta.json, so it is evaluated again."""
    module, _ = PROTOCOLS[name]
    values = _cached_workdir(tmp_path, name, 8)
    tag = tags(name)[1]
    steps, mode, ckpt = legs(name)[tag]
    meta = tmp_path / f"samples_{tag}" / "meta.json"
    if case == "meta_differs":
        meta.write_text(json.dumps({"n": 8, "steps": steps + 1, "mode": mode}))
    else:
        os.utime(tmp_path / f"samples_{tag}_20260101T000000.json", (1.0e9 - 1, 1.0e9 - 1))
    calls = []
    assert module.main([str(tmp_path), "8", "--device", "cpu"], run=_fake_legs(tmp_path, calls, 8)) == 0
    expected = ["sample_and_save", "evaluate"] if case == "meta_differs" else ["evaluate"]
    assert [c[0] for c in calls] == expected and {c[2] for c in calls} == {str(tmp_path)}
    sample_dir = str(tmp_path / f"samples_{tag}")
    if case == "meta_differs":
        a = calls[0][1]
        assert (flag(a, "--ckpt"), flag(a, "--output_dir"), flag(a, "--num_samples"), flag(a, "--batch_size"),
                flag(a, "--num_steps"), flag(a, "--mode"), flag(a, "--device")) == \
            (str(tmp_path / ckpt), sample_dir, "8", "64", str(steps), mode, "cpu")
        assert sorted(os.listdir(sample_dir)) == ["meta.json"] + [f"samples_{i:010d}.npz" for i in range(8)]
        assert meta.read_text() == f'{{"n": 8, "steps": {steps}, "mode": "{mode}"}}'
    a = calls[-1][1]
    assert (flag(a, "--ckpt"), flag(a, "--sample_dir"), flag(a, "--device")) == \
        (str(tmp_path / "ckpt" / "checkpoint.msgpack"), sample_dir, "cpu") and "--allow_random_extractors" in a
    values[tag] = 5.0
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{\n"):]) == _expected_table(name, values)


# ------------------------------------------------------- device and legs
@pytest.mark.parametrize("name", ["ddim", "flow"])
def test_without_a_card_the_protocol_raises_unless_told_cpu(tmp_path, env, monkeypatch, name):
    module, _ = PROTOCOLS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main([str(tmp_path)], run=lambda m, a, c: pytest.fail("a leg ran"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    args = quality.parse_args([], module.__name__.split(".")[-1], "", f"r2dm_{name}_quality")
    assert (args.workdir, args.num_samples, args.device) == \
        (os.path.join(__import__("tempfile").gettempdir(), f"r2dm_{name}_quality"), 64, "cuda")


def test_run_leg_is_a_process_in_the_workdir_and_exits_with_its_code(tmp_path, env, capfd):
    """From a directory outside the repo: the package comes from
    ``PYTHONPATH``; a leg's failure ends the protocol with its code."""
    quality.run_leg("reflow", ["--help"], str(tmp_path))
    assert "--teacher_steps" in capfd.readouterr().out
    with pytest.raises(SystemExit) as e:
        quality.run_leg("reflow", ["--ckpt", "a", "--out", "b", "--no_such_flag"], str(tmp_path))
    assert e.value.code == 2
    err = capfd.readouterr().err
    assert "error: unrecognized arguments: --no_such_flag" in err and "exited with 2" in err


# --------------------------------------------------- end to end (slow)
@pytest.mark.slow
@pytest.mark.parametrize("name", ["ddim", "flow"])
def test_protocol_end_to_end_in_smoke_mode(tmp_path, name):
    """``python -m r2dm_tpu_torch.<name>_quality_check WORK 8 --device cpu``
    under smoke mode, as ``tests/test_quality_scripts.py`` runs the script:
    the table under the script's key with its tags and row groups; a second
    run on the same workdir runs no leg and prints the same table.

    Every value is finite but the BEV MMD of a leg that holds a scan with no
    point in the histogram's range (3-63 m after the evaluation gate): the
    toy network (60 steps, still in its LR warmup) gives few-step chains
    whose every pixel clips to the far end, and an empty histogram
    normalises to 0/0 there, in the JAX package's ``compute_mmd_2d`` as in
    the port's (both are checked on the leg's histograms)."""
    module, smoke_var = PROTOCOLS[name]
    work = tmp_path / "work"
    env = {**{k: v for k, v in os.environ.items() if k not in KNOBS}, smoke_var: "1", "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", module.__name__, str(work), "8", "--device", "cpu"]
    runs = [subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=1200) for _ in range(2)]
    tables = []
    for proc in runs:
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        tables.append(json.loads(proc.stdout[proc.stdout.rindex('{\n  "' + module.KEY):]))
    rows = tables[0][module.KEY]
    assert list(rows) == ROWS and all(list(r) == tags(name, smoke=True) for r in rows.values())
    assert "leg " in runs[0].stdout and "leg " not in runs[1].stdout and tables[1] == tables[0]

    [cache] = work.glob("real_set_torch_*.npz")
    with np.load(cache) as f:
        real = f["bev_hists"]
    for tag in tags(name, smoke=True):
        scans = np.stack([np.load(p)["sample"] for p in sorted((work / f"samples_{tag}").glob("*.npz"))])
        mask = (scans[:, 0:1] > 0.5) & (scans[:, 0:1] < 63)
        clouds = torch.from_numpy(scans[:, 1:4] * mask).reshape(len(scans), 3, -1).transpose(1, 2)
        hists = bev.point_cloud_to_histogram(clouds).numpy()
        empty = bool((hists.reshape(len(hists), -1).sum(1) == 0).any())
        assert np.isnan(jax_bev.compute_mmd_2d(jnp.asarray(real), jnp.asarray(hists))) == empty
        for row, values in rows.items():
            assert np.isfinite(values[tag]) != (row == "bev.mmd" and empty), (tag, row, values[tag])
