"""What the two relative-quality protocols share: the train gate, the cached
sample and eval legs, and the summary table.

The port's counterpart of the code that ``tools/ddim_quality_check.sh`` and
``tools/flow_quality_check.sh`` repeat; ``ddim_quality_check`` and
``flow_quality_check`` are the protocols. Each leg is a separate process,
``python -m r2dm_tpu_torch.<cli>`` with ``--device``, run in the working
directory (where ``evaluate`` keeps its real-set cache) with the package's
root on ``PYTHONPATH``; a leg that fails stops the protocol with its exit
code, its output already on the console.

Caching is validated, not by file name (the scripts' rules):

- the checkpoint counts only with ``ckpt/.train_done``. Without it, a
  checkpoint whose ``training_config.json`` has the requested
  ``training.num_steps`` is resumed (a preempted run: the trainer exits 0 on
  SIGTERM), anything else is deleted and trained again; after training,
  ``.train_done`` is written only if the checkpoint reached the target;
- a sample directory counts only when its ``meta.json`` reads exactly
  ``{"n": N, "steps": S, "mode": "M"}``; otherwise it is deleted and sampled
  again;
- ``evaluate`` is skipped when a ``samples_<tag>_*.json`` newer than that
  ``meta.json`` exists;
- the summary takes each tag's newest eval JSON not older than its
  ``meta.json`` and raises ``StaleResult`` when there is none, when
  ``meta.n`` is not N, or when the JSON's ``info["#fake"]`` is not
  ``meta.n``.

Knobs, under the scripts' names: ``R2DM_QUALITY_TRAIN_STEPS`` (default
600; use a fresh working directory, the gate keys on the directory),
``R2DM_QUALITY_TRAIN_ARGS`` (raw trainer flags appended, split on
whitespace), ``R2DM_QUALITY_TRAIN_ONLY=1`` (stop after the gate). Smoke mode
(``R2DM_DDIMQ_SMOKE`` / ``R2DM_FLOWQ_SMOKE``) shrinks the sizes only; the
device is ``--device`` (``cuda`` by default), and without a card a protocol
raises unless it is given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shlex
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import torch

from .checkpoint import load_checkpoint
from .train import CHECKPOINT

ROOT = str(Path(__file__).resolve().parent.parent)  # the directory that holds the package
GROUPS = ("img", "pts", "bev")
# smoke mode's network: 16x128, base 8 (the scripts' SMALL_ARGS)
SMALL_ARGS = ["--data.projection", "spherical-256", "--data.resolution", "16,128",
              "--model.base_channels", "8", "--model.channel_multiplier", "1,2,2,2",
              "--model.num_residual_blocks", "1,1,1,1", "--model.gn_num_groups", "4",
              "--model.attn_num_heads", "2"]

Leg = Callable[[str, list, str], None]  # (module under r2dm_tpu_torch, argv, working directory)


class StaleResult(RuntimeError):
    """An eval result that is missing, older than its samples, or of
    another sample count than requested."""


@dataclass(frozen=True)
class Sizes:
    train_steps: int
    train_batch: int
    sample_batch: int
    small_args: tuple


def sizes(smoke: bool) -> Sizes:
    """The scripts' sizes: smoke mode's toy run, else the full-size one with
    ``R2DM_QUALITY_TRAIN_STEPS``."""
    if smoke:
        return Sizes(60, 8, 8, tuple(SMALL_ARGS))
    return Sizes(int(os.environ.get("R2DM_QUALITY_TRAIN_STEPS") or 600), 32, 64, ())


def run_leg(module: str, argv: list, cwd: str) -> None:
    """``python -m r2dm_tpu_torch.<module> argv`` in ``cwd``, the package's
    root on ``PYTHONPATH``; its output goes to the console. A leg that fails
    exits with its code."""
    cmd = [sys.executable, "-m", f"r2dm_tpu_torch.{module}", *argv]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    sys.stdout.flush()
    rc = subprocess.run(cmd, cwd=cwd, env=env).returncode
    if rc != 0:
        print(f"{shlex.join(cmd)} exited with {rc}", file=sys.stderr, flush=True)
        raise SystemExit(rc)


def parse_args(argv, prog: str, description: str, default_dir: str) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog=f"python -m r2dm_tpu_torch.{prog}", description=description)
    p.add_argument("workdir", nargs="?", default=os.path.join(tempfile.gettempdir(), default_dir))
    p.add_argument("num_samples", nargs="?", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu; every leg runs there")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the protocol runs on a card, or on the CPU with --device cpu")
    return args


def _stored_target(ckpt_dir: Path):
    """``training.num_steps`` of the run that wrote ``ckpt_dir``, or None."""
    try:
        with open(ckpt_dir / "training_config.json") as f:
            return json.load(f)["training"]["num_steps"]
    except (OSError, ValueError, KeyError, TypeError):
        return None


class Protocol:
    """One protocol run over ``work``: ``n`` samples a leg, every leg on
    ``device`` through ``run`` (``run_leg``: a process each)."""

    def __init__(self, work: str, n: int, device: str, run: Leg = run_leg):
        self.work = Path(work)
        self.n = n
        self.device = device
        self.run = run
        self.ckpt = str(self.work / "ckpt" / CHECKPOINT)
        self.work.mkdir(parents=True, exist_ok=True)

    def leg(self, module: str, argv: list) -> None:
        t0 = time.time()
        self.run(module, [*argv, "--device", self.device], str(self.work))
        print(f"leg {module}: {time.time() - t0:.1f} s", flush=True)

    def train_gate(self, size: Sizes, extra_args=()) -> bool:
        """Train (or resume) the checkpoint unless ``ckpt/.train_done``
        exists; False when ``R2DM_QUALITY_TRAIN_ONLY=1`` ends the protocol
        here."""
        ckpt_dir = self.work / "ckpt"
        if not (ckpt_dir / ".train_done").exists():
            resume = []
            if (ckpt_dir / CHECKPOINT).exists() and _stored_target(ckpt_dir) == size.train_steps:
                resume = ["--training.resume", self.ckpt]
                print(f"resuming preempted training from {self.ckpt}", flush=True)
            else:
                shutil.rmtree(ckpt_dir, ignore_errors=True)  # no usable checkpoint: a fresh run
            steps = str(size.train_steps)
            self.leg("train", ["--data.dataset", "synthetic", *extra_args, "--training.num_steps", steps,
                               "--training.batch_size_train", str(size.train_batch),
                               "--training.steps_save_model", steps, "--training.steps_save_image", "1000000",
                               *size.small_args, *(os.environ.get("R2DM_QUALITY_TRAIN_ARGS") or "").split(),
                               *resume, "--training.output_dir", str(ckpt_dir)])
            # the trainer exits 0 when preempted: the checkpoint must have reached the target
            try:
                step = load_checkpoint(self.ckpt)["global_step"]
            except OSError:
                step = -1
            if step < size.train_steps:
                print(f"checkpoint preempted before step {size.train_steps}; rerun to retrain", file=sys.stderr)
                raise SystemExit(1)
            (ckpt_dir / ".train_done").touch()
        if os.environ.get("R2DM_QUALITY_TRAIN_ONLY") == "1":
            print(f"train gate done (R2DM_QUALITY_TRAIN_ONLY=1): {ckpt_dir}")
            return False
        return True

    def sample_eval(self, ckpt: str, tag: str, steps: int, mode: str, batch: int) -> None:
        """The sample leg of ``tag`` unless its ``meta.json`` matches, then
        its eval leg unless a result newer than that ``meta.json`` exists;
        the eval uses the trained checkpoint's config."""
        out = self.work / f"samples_{tag}"
        meta_path = out / "meta.json"
        meta = json.dumps({"n": self.n, "steps": steps, "mode": mode})
        if not meta_path.is_file() or meta_path.read_text().rstrip("\n") != meta:
            shutil.rmtree(out, ignore_errors=True)
            self.leg("sample_and_save", ["--ckpt", ckpt, "--output_dir", str(out), "--num_samples", str(self.n),
                                         "--batch_size", str(batch), "--num_steps", str(steps), "--mode", mode])
            meta_path.write_text(meta)
        newer = [p for p in self.work.glob(f"samples_{tag}_*.json")
                 if p.stat().st_mtime_ns > meta_path.stat().st_mtime_ns]
        if not newer:
            self.leg("evaluate", ["--ckpt", self.ckpt, "--sample_dir", str(out), "--allow_random_extractors"])


def summary(work: str, n: int, tags: list, key: str) -> dict:
    """``{key: {"<group>.<metric>": {tag: value rounded to 4}}}`` over each
    tag's newest eval JSON not older than its ``meta.json``; the rows in the
    first tag's order. Raises ``StaleResult`` on a missing or stale JSON or
    a sample count other than ``n``."""
    def newest(tag):
        meta_path = os.path.join(work, f"samples_{tag}", "meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta["n"] != n:
            raise StaleResult(f"{tag}: meta.json {meta} is not of {n} samples")
        files = sorted(glob.glob(os.path.join(work, f"samples_{tag}_*.json")))
        if not files:
            raise StaleResult(f"no eval json for {tag}")
        newer = [f for f in files if os.path.getmtime(f) >= os.path.getmtime(meta_path)]
        if not newer:
            raise StaleResult(f"eval jsons for {tag} all predate its meta.json (stale)")
        with open(newer[-1]) as f:
            ev = json.load(f)
        got = ev.get("info", {}).get("#fake")
        if got != meta["n"]:
            raise StaleResult(f"{tag}: eval ran on {got} samples, meta says {meta['n']}")
        return ev

    evals = {t: newest(t) for t in tags}
    rows = {}
    for grp in GROUPS:
        for k in evals[tags[0]].get(grp, {}):
            rows[f"{grp}.{k}"] = {t: round(float(evals[t][grp][k]), 4) for t in tags}
    return {key: rows}
