"""The program's own tracing (``r2dm_tpu_torch/utils/trace.py``) under the
harness: a tiny untraced run of each cell leaves it off, with no span
recorded, so every timed run measures the program with tracing off."""

from __future__ import annotations

import pytest
import torch

from . import tiny

torch.set_num_threads(1)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_an_untraced_run_leaves_the_program_s_tracing_off(cell):
    from r2dm_tpu_torch.utils import trace

    trace.disable()
    trace.reset()
    out = tiny.run(tiny.context(cell))
    assert tiny.correct(out), out.checks
    assert not trace.on()
    assert trace.snapshot()["spans"] == []
