"""The correctness check of every cell, driven on the CPU at a tiny size with
the chip's look skipped: sound runs pass it, and runs with the timed path
broken underneath fail it, once for each fault the cell can have (a step
that returns its state unchanged; half of the batch left out, the mean taken
over the rest; an answer altered where it is produced). The four cells run
on one card, so there is no exchange between chips to leave out. The
control (the program's int8 lane, or the reference in fp8, as the
architecture module names it) needs the card and its sizes: the ``cuda`` tests run it through ``python -m benchmark.run``."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import manifest
from benchmark.faults import FAULTS, plant

from . import tiny

torch.set_num_threads(1)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_run_is_correct(cell):
    out = tiny.run(tiny.context(cell))
    assert out.attempted > 0 and out.failed == 0
    assert tiny.correct(out), out.checks
    assert set(out.metrics) == {m["name"] for m in manifest.end_to_end(manifest.load(), cell)}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_broken_run_is_not_correct(cell, fault):
    ctx = tiny.context(cell)
    with plant(fault, ctx):
        out = tiny.run(ctx)
    assert not tiny.correct(out), out.checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")


def control(cell: str) -> str:
    """The cell's control, as its architecture module names it for its
    driver."""
    m = manifest.load()
    cfg = manifest.config(m, manifest.cell(m, cell)["config"])
    return manifest.architecture(cfg).CONTROLS[manifest.traffic(cell)["driver"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_is_not_correct(card, cell):
    """The control at the cell's own sizes, a short window: the one the
    architecture module names (the program's int8 lane for the U-Net's
    sampling cells, the reference in fp8 elsewhere)."""
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed", str(2**33 + 101), "--seconds", "3",
         "--trace", "0", "--control", control(cell)],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=900, env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is False
