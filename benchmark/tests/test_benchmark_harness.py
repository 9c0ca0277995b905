"""The harness: the manifest against the contract's rules, every cell,
configuration and metric found by name, the result line's keys, the refusals
(no card; a directory without the program), and what may be imported."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import manifest as mf
from benchmark import run as bench_run
from benchmark.drivers.common import Outcome
from benchmark.trace import Profile

from .tiny import CELLS

torch.set_num_threads(1)
ROOT = mf.ROOT
M = mf.load()
TEXT = re.compile(r"^[^\n\t]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def test_manifest_follows_the_contract():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32 and all(TEXT.match(w) for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    names = [c["name"] for c in M["configs"]] + CELLS + [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert mf.NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        assert all(mf.NAME.match(k) for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert mf.NAME.match(w["name"]) and mf.NAME.match(w["config"]) and mf.NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in M["end_to_end"])
    e2e = {m["name"] for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert set(m) == METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in e2e and TEXT.match(m["layer"]) and set(m["workloads"]) <= set(CELLS)
    for m in M["end_to_end"] + M["per_layer"]:
        assert mf.NAME.match(m["name"]) and mf.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    # one layer name per layer, letter for letter
    assert {m["layer"] for m in M["per_layer"]} == {"kernels", "network", "device", "sampler", "trainer", "data"}


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_loads_by_name(cell):
    entry = mf.cell(M, cell)
    traffic = mf.traffic(cell)
    assert traffic["config"] == entry["config"]
    cfg = mf.config(M, entry["config"])
    assert cfg["name"] == entry["config"] and cfg["reduced"] == next(
        c["reduced"] for c in M["configs"] if c["name"] == entry["config"])
    assert (ROOT / "benchmark" / "drivers" / f"{traffic['driver']}.py").exists()
    e2e = [m["name"] for m in mf.end_to_end(M, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = mf.per_layer(M, cell)
    assert layer and all(m["moves"] in e2e for m in layer)
    assert set(traffic["limits"]) and all(v >= 0 for v in traffic["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in M["per_layer"]])
def test_each_metric_reader_loads_and_reads_nothing_without_a_trace(metric):
    read = mf.reader(metric)
    assert read({}) is None
    assert read({"profile": Profile(1.0, 0.0, 0, [], [], {}), "loader_wait_s": []}) is None


def _profile():
    return Profile(window_s=2.0, busy_s=1.5, kernels=1200, device_ops=[["k", 1.0]], idle_gaps=[["a: b", 0.1]],
                   ranges={"ringconv": {"calls": 48, "device_s": 0.2, "least_s": 0.05},
                           "group_norm": {"calls": 50, "device_s": 0.1, "least_s": 0.04}})


def _span(name, t0, t1, d0=None, d1=None, request=None, thread="MainThread"):
    return {"name": name, "t0": t0, "t1": t1, "d0": d0, "d1": d1, "request": request, "thread": thread,
            "parent": None}


def _program():
    """A program-traced segment from 20.0 to 20.5 s of the host's clock
    (``program_traced``), with three requests' denoising steps before it (the
    readers of spans do not clip them to the segment) and two train steps."""
    return {"t0": 20.0, "t1": 20.5, "units": 3, "counters": {"data.gets": 4, "data.gets_empty": 1},
            "spans": [
                # request 1: two steps (host 20 and 24 ms, leads 1 and 5 ms), a forward of 16 ms
                _span("sampler.step", 10.000, 10.020, 10.001, 10.025, 1),
                _span("network.forward", 10.002, 10.018, request=1),
                _span("sampler.step", 10.020, 10.044, 10.025, 10.050, 1),
                # request 2: 4 ms after request 1's last step on the device; host 28 and 16, leads 2 and 5
                _span("sampler.step", 10.052, 10.080, 10.054, 10.085, 2),
                _span("sampler.step", 10.080, 10.096, 10.085, 10.100, 2),
                # request 3: 6 ms after; host 28, lead 4
                _span("sampler.step", 10.102, 10.130, 10.106, 10.140, 3),
                # two train steps, leads 0.5 and 1.5 ms, updates of 7 and 9 ms
                _span("train.step", 20.000, 20.200, 20.0005, 20.260),
                _span("train.update", 20.190, 20.197),
                _span("train.step", 20.300, 20.500, 20.3015, 20.560),
                _span("train.update", 20.490, 20.499),
                # the loader's thread: 10 ms inside the segment of a batch begun before it, and 10 ms
                _span("data.make_batch", 19.990, 20.010, thread="loader"),
                _span("data.make_batch", 20.250, 20.260, thread="loader")]}


PROGRAM_METRICS = ("host_step_ms.serve", "host_forward_ms.serve", "device_lead_ms.serve", "device_gap_ms.serve",
                   "device_lead_ms.train", "host_update_ms.train", "loader_empty_share.train",
                   "loader_busy_share.train")


def test_readers_on_a_trace():
    obs = {"profile": _profile(), "profile_host": _profile(), "denoising_steps": 4, "enqueue_s": 0.9,
           "step_wall_s": 1.0, "loader_wait_s": [0.001, 0.003],
           "window": {"seconds": 40.0, "units": 100, "profile_units": 5, "flops_per_unit": 0.2 * 989e12},
           "program": _program()}
    got = {m["name"]: mf.reader(m["name"])(obs) for m in M["per_layer"]}
    assert got["roofline.ringconv.sample"] == pytest.approx(25.0)
    assert got["roofline.gn.sample"] == pytest.approx(40.0)
    assert got["mfu.sample"] == got["mfu.serve"] == got["mfu.train"] == pytest.approx(50.0)
    # 1.5 busy seconds over 5 profiled units: 0.3 s a unit, 30 s of the window's 40
    assert got["device_idle.train"] == pytest.approx(25.0)
    assert got["launches_per_step.serve"] == 300
    assert got["enqueue_share.train"] == pytest.approx(90.0)
    assert got["loader_wait_ms.train"] == pytest.approx(2.0)
    # (20 + 24 + 28 + 16 + 28) / 5 ms a step; one forward of 16 ms; leads (1 + 5 + 2 + 5 + 4) / 5
    assert got["host_step_ms.serve"] == pytest.approx(23.2)
    assert got["host_forward_ms.serve"] == pytest.approx(16.0)
    assert got["device_lead_ms.serve"] == pytest.approx(3.4)
    assert got["device_gap_ms.serve"] == pytest.approx(5.0)  # (4 + 6) / 2
    assert got["device_lead_ms.train"] == pytest.approx(1.0)
    assert got["host_update_ms.train"] == pytest.approx(8.0)
    assert got["loader_empty_share.train"] == pytest.approx(25.0)  # 1 of 4 gets
    assert got["loader_busy_share.train"] == pytest.approx(4.0)  # 20 ms of the segment's 500
    without = {k: v for k, v in obs.items() if k != "program"}
    assert {m: mf.reader(m)(without) for m in PROGRAM_METRICS} == dict.fromkeys(PROGRAM_METRICS)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(monkeypatch, trace):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    cell = mf.cell(M, "r2dm-h.ddim16-b8-closed")
    out = Outcome(attempted=120, failed=0, metrics={"request_p90_ms": 350.0, "setup_s": 20.0},
                  observed={"profile": _profile(), "denoising_steps": 48,
                            "window": {"seconds": 40.0, "units": 120, "profile_units": 3, "flops_per_unit": 1e12}},
                  checks={"eps": (0.01, 0.02), "step": (float("inf"), 0.1)}, peak=123)
    line = bench_run.result(M, cell, out, trace, None)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is False  # an infinite reading fails
    assert json.loads(json.dumps(line, allow_nan=False)) == line
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert set(line["metrics"]) == {"mfu.serve", "device_idle.serve", "launches_per_step.serve"}
        assert line["device"]["busy_s"] == 1.5 and line["device"]["window_s"] == 2.0
    else:
        assert set(line["metrics"]) == {"request_p90_ms", "setup_s"}


def _no_result(proc) -> bool:
    return not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", str(2**40 + 3),
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and _no_result(proc)
    assert "needs 1 CUDA card" in proc.stderr


FAKE_CARD = ("import sys, torch; torch.cuda.is_available = lambda: True; torch.cuda.device_count = lambda: 1; "
             "torch.cuda.set_device = lambda d: None; from benchmark import run; "
             "sys.exit(run.main(['--workload', sys.argv[1], '--seed', '7', '--seconds', '1']))")


def test_refuses_in_a_directory_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", FAKE_CARD, CELLS[0]], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and _no_result(proc)
    assert "r2dm_tpu_torch" in proc.stderr


CLOSURE = """
import sys, torch
torch.set_num_threads(1)
from benchmark import run
from benchmark.tests import tiny
tiny.run(tiny.context(sys.argv[1], seconds=0.2))
found = run.forbidden_modules()
print("FOUND", found)
sys.exit(1 if found else 0)
"""


@pytest.mark.parametrize("cell", CELLS)
def test_import_closure_has_no_jax(cell):
    """A whole tiny run of the cell's driver in a fresh interpreter loads no
    module whose top-level name is JAX's, its libraries' or the JAX
    package's (``r2dm_tpu``; the port's ``r2dm_tpu_torch`` is not it)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", CLOSURE, cell], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "FOUND []" in proc.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "r2dm_tpu_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    assert not [m for m in bench_run.forbidden_modules() if m in ("r2dm_tpu_torch_lookalike", "jaxfoo")]
    monkeypatch.setitem(sys.modules, "r2dm_tpu.models", sys)
    assert "r2dm_tpu.models" in bench_run.forbidden_modules()


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "benchmark" / "reference").glob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & {"r2dm_tpu_torch", "r2dm_tpu", "jax", "jaxlib", "flax", "optax", "benchmark"}, f


def test_harness_imports_nothing_of_jax():
    for f in sorted((ROOT / "benchmark").rglob("*.py")):
        assert not _imports(f) & {"r2dm_tpu", "jax", "jaxlib", "flax", "optax"}, f
