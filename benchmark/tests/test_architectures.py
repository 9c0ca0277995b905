"""Each network known through its architecture module (``architectures/``),
and only there.

The readings of each configuration and of each architecture are frozen in
files of their own, ``frozen/configs/<config>.json`` and
``frozen/architectures/<architecture>.json`` (``readings.py`` says what they
hold and writes a missing one), computed by the harness before it moved what
depends on a network into these modules. A move that changed any of them
would change what the benchmark reads. A configuration or architecture
without its file fails here, naming the file to add.

No file of the harness's shared code names a network. A configuration of a
new architecture enters as new files and new entries in ``BENCHMARK.json``
alone: a checkout with a planted ``toy`` architecture (the U-Net's reference
and port at sizes of its own, with no int8 lane of its own) runs every driver
to ``correct``, and to not correct with half the batch left out underneath
and with its control, the reference in fp8, in the program's place; and the
harness's own tests pass in it, the toy's frozen files, probes and a metric
of the program's trace among them."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import pytest
import torch

from benchmark import manifest
from benchmark.drivers.common import program_config
from benchmark.roofline import flops

from . import readings

torch.set_num_threads(1)
M = manifest.load()
CONFIGS = [c["name"] for c in M["configs"]]
ARCHITECTURES = sorted({manifest.config(M, c)["architecture"] for c in CONFIGS})
NETWORK_NAMES = re.compile(r"efficient_unet|refinenet|EfficientUNet|RefineNet|ResidualBlock")
# the harness's own kinds of file that may name a network: a network's own
# module and reference, and the tests
MAY_NAME = ("architectures", "reference", "tests")
# and one metric's reader, whose docstring names the callable it reads
MAY_NAME_FILES = ("metrics/roofline.ringconv.sample.py",)


def _cfg(name: str) -> dict:
    return manifest.config(M, name)


def _frozen(path: Path):
    if not path.is_file():
        pytest.fail(f"no frozen readings: add {os.path.relpath(path, manifest.ROOT)} "
                    f"(python -m benchmark.tests.readings <config> writes it)", pytrace=False)
    return json.loads(path.read_text())


@pytest.mark.parametrize("config", CONFIGS)
def test_state_dict_bytes_are_frozen(config):
    frozen = _frozen(readings.config_file(config))
    assert readings.tiny_leaves(_cfg(config)) == frozen["tiny_leaves"]


@pytest.mark.parametrize("config", CONFIGS)
def test_parameter_names_and_shapes_are_frozen(config):
    frozen = _frozen(readings.config_file(config))
    assert readings.shapes(_cfg(config)) == {k: frozen[k] for k in ("parameters", "numel", "shapes_sha256")}


def _overlaid(frozen: dict) -> dict:
    """The port's default ``Config`` with the frozen fields set on it."""
    out = readings.default_config()
    for section, fields in frozen.items():
        out[section].update(fields)
    return out


@pytest.mark.parametrize("config", CONFIGS)
def test_program_config_is_frozen(config):
    frozen = _frozen(readings.config_file(config))
    cfg = _cfg(config)
    assert readings.plain(asdict(program_config(cfg))) == _overlaid(frozen["program_config"])
    assert readings.plain(asdict(program_config(readings.tiny(cfg)))) == _overlaid(frozen["program_config_tiny"])


@pytest.mark.parametrize("config", CONFIGS)
def test_forward_flops_are_frozen(config):
    frozen = _frozen(readings.config_file(config))
    assert flops.forward_flops(_cfg(config)) == frozen["forward_flops"]
    assert flops.forward_flops(readings.tiny(_cfg(config))) == frozen["forward_flops_tiny"]


@pytest.mark.parametrize("architecture", ARCHITECTURES)
def test_chain_wraps_the_frozen_callables(architecture):
    cfg = next(_cfg(c) for c in CONFIGS if _cfg(c)["architecture"] == architecture)
    frozen = _frozen(readings.architecture_file(architecture))
    assert readings.wrapped(manifest.architecture(cfg)) == frozen


@pytest.mark.parametrize("test", [test_state_dict_bytes_are_frozen, test_parameter_names_and_shapes_are_frozen,
                                  test_program_config_is_frozen, test_forward_flops_are_frozen,
                                  test_chain_wraps_the_frozen_callables], ids=lambda t: t.__name__)
def test_a_missing_frozen_file_fails_by_name(tmp_path, monkeypatch, test):
    monkeypatch.setattr(readings, "FROZEN", tmp_path)
    kind, name = ("architectures", "efficient_unet") if test is test_chain_wraps_the_frozen_callables else (
        "configs", "r2dm-h")
    with pytest.raises(pytest.fail.Exception, match=f"no frozen readings: add .*{kind}/{name}.json"):
        test(name)


def test_no_shared_file_names_a_network():
    here = manifest.HERE
    named = [str(p.relative_to(here)) for p in sorted(here.rglob("*.py"))
             if p.relative_to(here).parts[0] not in MAY_NAME and p.relative_to(here).as_posix() not in MAY_NAME_FILES
             and NETWORK_NAMES.search(p.read_text())]
    assert named == []


def test_an_unknown_architecture_is_refused_by_name(tmp_path):
    with pytest.raises(KeyError, match="'absent'.*no .*architectures/absent.py"):
        manifest.architecture({"name": "absent-1", "architecture": "absent"})
    with pytest.raises(KeyError, match="no "):
        manifest.architecture({"architecture": "../drivers/common"})
    (tmp_path / "benchmark" / "architectures").mkdir(parents=True)
    (tmp_path / "benchmark" / "architectures" / "toy.py").write_text("TINY = {'base_channels': 4}\n")
    assert manifest.architecture({"architecture": "toy"}, root=tmp_path).TINY == {"base_channels": 4}


TOY = '''"""A planted architecture: the U-Net's reference and port at sizes of its
own, and no int8 lane: its control is the reference in fp8. The traced
chain attributes its GroupNorm, frozen on probes of its own sizes."""

import torch

from benchmark.drivers.common import ray_angles
from benchmark.reference.toy import ToyNet
from benchmark.roofline import PEAK_FP32_FLOPS, kernels

TINY = {"resolution": [16, 64], "base_channels": 4, "channel_multiplier": [1, 2, 2, 4],
        "num_residual_blocks": [1, 1, 1, 1], "gn_num_groups": 2, "attn_num_heads": 1}
GAINS = ("norm1.weight", "norm.weight")
CONTROLS = {"chain": "fp8", "closed_loop": "fp8", "train": "fp8"}


def reference_net(cfg):
    return ToyNet(in_channels=cfg["in_channels"], resolution=tuple(cfg["resolution"]),
                         base_channels=cfg["base_channels"], channel_multiplier=tuple(cfg["channel_multiplier"]),
                         num_residual_blocks=tuple(cfg["num_residual_blocks"]), gn_num_groups=cfg["gn_num_groups"],
                         gn_eps=cfg["gn_eps"], attn_num_heads=cfg["attn_num_heads"])


def extra_state(cfg, device):
    return {"coords": ray_angles(cfg, device)}


def program_model(cfg, m):
    m.architecture, m.base_channels = "efficient_unet", cfg["base_channels"]
    m.channel_multiplier, m.num_residual_blocks = tuple(cfg["channel_multiplier"]), tuple(cfg["num_residual_blocks"])
    m.gn_num_groups, m.gn_eps, m.attn_num_heads = cfg["gn_num_groups"], cfg["gn_eps"], cfg["attn_num_heads"]
    m.coords_encoding = cfg["coords_encoding"]


def program_net():
    from r2dm_tpu_torch.models.efficient_unet import EfficientUNet as Port

    return Port


def flops(cfg):
    """The convolutions alone, each at its output's resolution."""
    counted = []
    with torch.device("meta"):
        net = reference_net(cfg)
        hooks = [m.register_forward_hook(lambda m, a, y: counted.append(2 * y[0, 0].numel() * m.weight.numel()))
                 for m in net.modules() if getattr(m, "weight", None) is not None and m.weight.dim() == 4]
        net(torch.zeros(1, *cfg["resolution"], cfg["in_channels"]), torch.zeros(1))
    for hk in hooks:
        hk.remove()
    return {"conv": sum(counted)}


def wrapped_work():
    from r2dm_tpu_torch.models import layers

    def group_norm(args, y):
        x = args[0]
        return kernels.least_seconds(*kernels.group_norm(x.numel(), x.element_size(), y.element_size()),
                                     PEAK_FP32_FLOPS)

    return [(layers, "fused_group_norm_silu", "group_norm", group_norm)]


def wrapped_probes():
    x = torch.empty(4, 16, 64, 8, dtype=torch.bfloat16, device="meta")
    return {"group_norm": [((x,), x), ((x,), x.float())]}
'''

TOY_REFERENCE = '''"""A planted architecture's plain reference: the U-Net's, at its own sizes."""

from .unet import EfficientUNet as ToyNet  # noqa: F401
'''

# a per-layer metric of the program's trace, as a configuration's PR adds one
TOY_METRIC = '''"""A denoising step's host time in the program-traced steps, in milliseconds."""

from benchmark.program_trace import span_ms


def read(observed):
    return span_ms(observed, "sampler.step")
'''

RUN_TOY = """
import json, sys, torch
torch.set_num_threads(1)
from benchmark import manifest
from benchmark.faults import plant
from benchmark.roofline import flops
from benchmark.tests import tiny
cell = sys.argv[1]
ctx = tiny.context(cell, seconds=0.2)
out = tiny.run(ctx)
broken = tiny.context(cell, seconds=0.2)
with plant("half_batch", broken):
    broken_out = tiny.run(broken)
control = manifest.architecture(ctx.cfg).CONTROLS[ctx.traffic["driver"]]
control_out = tiny.run(tiny.context(cell, seconds=0.2, control=control))
try:
    tiny.run(tiny.context(cell, seconds=0.2, control="int8"))
    int8 = "ran"
except ValueError as e:
    int8 = str(e)
print(json.dumps({"architecture": ctx.cfg["architecture"], "base_channels": ctx.cfg["base_channels"],
                  "correct": tiny.correct(out), "attempted": out.attempted, "metrics": sorted(out.metrics),
                  "reported": sorted(m["name"] for m in manifest.end_to_end(manifest.load(), cell)),
                  "half_batch_correct": tiny.correct(broken_out), "flops": flops.forward_flops(ctx.cfg),
                  "control": control, "control_checks": control_out.checks,
                  "control_correct": tiny.correct(control_out), "int8": int8}))
"""


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """A checkout of the benchmark with the ``toy`` architecture added as
    new files (its module and reference, its configuration, one cell a
    driver, a per-layer metric of the program's trace, and its frozen files
    as ``readings.py`` writes them) and new entries in ``BENCHMARK.json``
    (each toy cell also in the metric lists of the cell whose traffic it
    copies); no file of the harness is edited."""
    root = tmp_path_factory.mktemp("planted")
    shutil.copy(manifest.ROOT / "BENCHMARK.json", root)
    shutil.copytree(manifest.HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(manifest.ROOT / "r2dm_tpu_torch", root / "r2dm_tpu_torch")
    bench = root / "benchmark"
    (bench / "architectures" / "toy.py").write_text(TOY)
    (bench / "reference" / "toy.py").write_text(TOY_REFERENCE)
    (bench / "metrics" / "host_step_ms.toy.py").write_text(TOY_METRIC)
    cfg = dict(_cfg("r2dm-h"), name="toy", architecture="toy", reduced=[])
    (bench / "configs" / "toy.json").write_text(json.dumps(cfg, indent=1))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "toy", "source": "a test's own", "file": "benchmark/configs/toy.json",
                         "reduced": [], "why": "planted"})
    cells = {}
    for w in list(m["workloads"]):
        traffic = manifest.traffic(w["name"])
        name = f"toy.{w['traffic']}"
        if traffic["driver"] in cells:
            continue
        cells[traffic["driver"]] = name
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(dict(traffic, config="toy")))
        m["workloads"].append(dict(w, name=name, config="toy"))
        for e in m["end_to_end"] + m["per_layer"]:
            if w["name"] in e.get("workloads", []):
                e["workloads"].append(name)
    m["per_layer"].append({"name": "host_step_ms.toy", "unit": "ms", "better": "lower", "source": "program_span",
                           "layer": "sampler", "moves": "sample_img_per_s", "workloads": [cells["chain"]]})
    (root / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    proc = subprocess.run([sys.executable, "-m", "benchmark.tests.readings", "toy"], cwd=root, env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return root, cells


def _env() -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH="")


def _edits(root: Path) -> list:
    """What a checkout at ``root`` changed of this tree's benchmark, beyond
    adding files and entries: the harness's files that differ or are gone,
    and the entries of ``BENCHMARK.json`` that are not as they were, apart
    from cells appended to a metric's ``workloads``."""
    out = [str(p.relative_to(manifest.ROOT)) for p in sorted(manifest.HERE.rglob("*"))
           if p.is_file() and "__pycache__" not in p.parts
           and not ((root / p.relative_to(manifest.ROOT)).is_file()
                    and (root / p.relative_to(manifest.ROOT)).read_bytes() == p.read_bytes())]
    ours, theirs = manifest.load(), manifest.load(root)
    for key, value in ours.items():
        if not isinstance(value, list):
            out += [f"BENCHMARK.json {key}"] if theirs[key] != value else []
            continue
        for a, b in zip(value, theirs[key]):
            if "workloads" in a and b.get("workloads", [])[:len(a["workloads"])] == a["workloads"]:
                b = dict(b, workloads=a["workloads"])
            out += [f"BENCHMARK.json {key} {a['name']}"] if a != b else []
        out += [f"BENCHMARK.json {key}: fewer entries"] if len(theirs[key]) < len(value) else []
    return out


@pytest.mark.parametrize("driver", ["chain", "closed_loop", "train"])
def test_a_planted_architecture_runs_every_driver(planted, driver):
    root, cells = planted
    assert not (manifest.HERE / "architectures" / "toy.py").exists()
    proc = subprocess.run([sys.executable, "-c", RUN_TOY, cells[driver]], cwd=root, env=_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["architecture"] == "toy" and got["base_channels"] == 4
    assert got["correct"] and got["attempted"] > 0
    assert got["metrics"] == got["reported"]
    assert not got["half_batch_correct"] and got["flops"] > 0
    assert got["control"] == "fp8" and not got["control_correct"], got["control_checks"]
    assert got["int8"] != "ran"  # refused: the toy's network has no int8 lane, and training's control is fp8


def test_a_planted_architecture_passes_the_harness_s_own_tests(planted):
    """The harness's own tests in the planted checkout, on the CPU (all but
    the planted ones, which would plant again): the toy's frozen readings
    and probes, its cells by name, its metric's reader, its traced tiny runs
    and their program trace, with nothing of the tree edited."""
    root, cells = planted
    assert _edits(root) == []
    tests = [f"benchmark/tests/{f}.py" for f in ("test_architectures", "test_benchmark_harness", "test_program_trace")]
    proc = subprocess.run([sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider", "-k", "not planted",
                           "--basetemp", str(root / "_pytest"), *tests], cwd=root, env=_env(), capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-8000:] + proc.stderr[-2000:]
    toy_cases = [f"{t}[toy]" for t in ("test_state_dict_bytes_are_frozen", "test_parameter_names_and_shapes_are_frozen",
                                       "test_program_config_is_frozen", "test_forward_flops_are_frozen",
                                       "test_chain_wraps_the_frozen_callables")]
    toy_cases += ["test_each_metric_reader_loads_and_reads_nothing_without_a_trace[host_step_ms.toy]"]
    toy_cases += [f"{t}[{c}]" for c in cells.values()
                  for t in ("test_each_cell_loads_by_name", "test_import_closure_has_no_jax",
                            "test_a_traced_run_keeps_the_program_s_trace_and_turns_it_off")]
    passed = set(re.findall(r"::(\S+) PASSED", proc.stdout))
    assert not set(toy_cases) - passed, proc.stdout[-4000:]
