"""The program's own tracing (``r2dm_tpu_torch/utils/trace.py``) under the
harness: a tiny untraced run of each cell leaves it off, with no span
recorded, so every timed run measures the program with tracing off; a tiny
traced run turns it on for its program-traced segment alone, and keeps in
``observed["program"]`` what the cell's metrics of the program's trace
read."""

from __future__ import annotations

import importlib

import pytest
import torch

from benchmark import manifest
from benchmark.trace import Profile

from . import tiny

torch.set_num_threads(1)
PROGRAM_SOURCES = ("program_span", "program_counter")


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_an_untraced_run_leaves_the_program_s_tracing_off(cell):
    from r2dm_tpu_torch.utils import trace

    trace.disable()
    trace.reset()
    out = tiny.run(tiny.context(cell))
    assert tiny.correct(out), out.checks
    assert not trace.on()
    assert trace.snapshot()["spans"] == []
    assert "program" not in out.observed


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_traced_run_keeps_the_program_s_trace_and_turns_it_off(cell, monkeypatch):
    """``--trace 1`` on the CPU, with the profiler's windows (which need the
    card) run untraced in its place."""
    from r2dm_tpu_torch.utils import trace

    ctx = tiny.context(cell)
    ctx.trace = True
    driver = importlib.import_module(f"benchmark.drivers.{ctx.traffic['driver']}")

    def profiled(segment, wrap=(), device=None, host=False):
        assert not trace.on()
        segment()
        return Profile(window_s=1.0, busy_s=0.5, kernels=0, device_ops=[], idle_gaps=[])

    monkeypatch.setattr(driver, "profiled", profiled)
    out = tiny.run(ctx)
    assert tiny.correct(out), out.checks
    assert not trace.on()
    assert trace.snapshot()["spans"] == []
    program = out.observed["program"]
    assert program["units"] == ctx.traffic.get("profile_steps", ctx.traffic.get("profile_requests"))
    assert program["t1"] > program["t0"] and program["spans"]
    assert all(program["t0"] <= s["t0"] and s["t1"] <= program["t1"] for s in program["spans"])
    # on the CPU the device keeps pace with the host: each span's work runs
    # on it from the span's start to its end
    paced = dict(out.observed, program=dict(program, spans=[dict(s, d0=s["t0"], d1=s["t1"])
                                                            for s in program["spans"]]))
    metrics = [m["name"] for m in manifest.per_layer(manifest.load(), cell) if m["source"] in PROGRAM_SOURCES]
    assert {m: manifest.reader(m)(paced) is not None for m in metrics} == dict.fromkeys(metrics, True)
