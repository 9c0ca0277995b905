"""Each network known through its architecture module (``architectures/``),
and only there.

The readings of every configuration are frozen in ``frozen_readings.json``,
computed by the harness before it moved what depends on a network into
these modules: the benchmark's weights leaf by leaf at the tiny sizes (a
sha256 of each leaf's bytes, on the CPU), the parameters' names and shapes at
full size, the fields of the port's ``Config`` that the harness sets (every
other field is the port's own default), the operations of a forward, and the
callables the traced chain attributes with the least seconds of two calls'
work. A move that changed any of them would change what the benchmark reads.

No file of the harness's shared code names a network. A configuration of a
new architecture enters as new files and new entries in ``BENCHMARK.json``
alone: a checkout with a planted ``toy`` architecture (the U-Net's reference
and port at sizes of its own, with no int8 lane of its own) runs every driver
to ``correct``, and to not correct with half the batch left out underneath
and with its control, the reference in fp8, in the program's place."""

from __future__ import annotations

import hashlib
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

from benchmark import manifest, weights
from benchmark.drivers.common import program_config
from benchmark.roofline import flops

torch.set_num_threads(1)
M = manifest.load()
FROZEN = json.loads((Path(__file__).parent / "frozen_readings.json").read_text())
CONFIGS = [c["name"] for c in M["configs"]]
CHAIN_CELLS = [w["name"] for w in M["workloads"] if manifest.traffic(w["name"])["driver"] == "chain"]
NETWORK_NAMES = re.compile(r"efficient_unet|refinenet|EfficientUNet|RefineNet|ResidualBlock")
# the harness's own kinds of file that may name a network: a network's own
# module and reference, and the tests
MAY_NAME = ("architectures", "reference", "tests")
# and one metric's reader, whose docstring names the callable it reads
MAY_NAME_FILES = ("metrics/roofline.ringconv.sample.py",)


def _cfg(name: str) -> dict:
    return manifest.config(M, name)


def _tiny(cfg: dict) -> dict:
    return json.loads(json.dumps(dict(cfg, **manifest.architecture(cfg).TINY)))


def _plain(x):
    return json.loads(json.dumps(x))


@pytest.mark.parametrize("config", CONFIGS)
def test_state_dict_bytes_are_frozen(config):
    sd = weights.make_state_dict(_tiny(_cfg(config)), FROZEN["seed"], "cpu")
    got = [[n, hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()] for n, t in sd.items()]
    assert got == FROZEN["configs"][config]["tiny_leaves"]


@pytest.mark.parametrize("config", CONFIGS)
def test_parameter_names_and_shapes_are_frozen(config):
    frozen = FROZEN["configs"][config]
    with torch.device("meta"):
        shapes = [[n, list(p.shape)] for n, p in weights.reference_net(_cfg(config)).named_parameters()]
    assert len(shapes) == frozen["parameters"]
    assert sum(torch.Size(s).numel() for _, s in shapes) == frozen["numel"]
    assert hashlib.sha256(json.dumps(shapes).encode()).hexdigest() == frozen["shapes_sha256"]


def _overlaid(frozen: dict) -> dict:
    """The port's default ``Config`` with the frozen fields set on it."""
    from r2dm_tpu_torch.config import Config

    out = _plain(asdict(Config()))
    for section, fields in frozen.items():
        out[section].update(fields)
    return out


@pytest.mark.parametrize("config", CONFIGS)
def test_program_config_is_frozen(config):
    frozen = FROZEN["configs"][config]
    assert _plain(asdict(program_config(_cfg(config)))) == _overlaid(frozen["program_config"])
    assert _plain(asdict(program_config(_tiny(_cfg(config))))) == _overlaid(frozen["program_config_tiny"])


@pytest.mark.parametrize("config", CONFIGS)
def test_forward_flops_are_frozen(config):
    frozen = FROZEN["configs"][config]
    assert flops.forward_flops(_cfg(config)) == frozen["forward_flops"]
    assert flops.forward_flops(_tiny(_cfg(config))) == frozen["forward_flops_tiny"]


def _owner(o) -> str:
    return o.__name__ if isinstance(o, type(sys)) else f"{o.__module__}.{o.__qualname__}"


@pytest.mark.parametrize("cell", CHAIN_CELLS)
def test_chain_wraps_the_frozen_callables(cell):
    cfg = _cfg(manifest.cell(M, cell)["config"])
    h = torch.empty(8, 64, 1024, 64, dtype=torch.bfloat16, device="meta")
    y = torch.empty(8, 64, 1024, 128, dtype=torch.bfloat16, device="meta")
    y32 = torch.empty(8, 64, 1024, 128, dtype=torch.float32, device="meta")
    got = [[_owner(o), attr, label, [work((h, h, h), y), work((h, h, h), y32)]]
           for o, attr, label, work in manifest.architecture(cfg).wrapped_work()]
    assert got == FROZEN["chain_wrapped"]


def test_no_shared_file_names_a_network():
    here = manifest.HERE
    named = [str(p.relative_to(here)) for p in sorted(here.rglob("*.py"))
             if p.relative_to(here).parts[0] not in MAY_NAME and p.relative_to(here).as_posix() not in MAY_NAME_FILES
             and NETWORK_NAMES.search(p.read_text())]
    assert named == []


def test_an_unknown_architecture_is_refused_by_name(tmp_path):
    with pytest.raises(KeyError, match="'toy'.*no .*architectures/toy.py"):
        manifest.architecture({"name": "toy-1", "architecture": "toy"})
    with pytest.raises(KeyError, match="no "):
        manifest.architecture({"architecture": "../drivers/common"})
    (tmp_path / "benchmark" / "architectures").mkdir(parents=True)
    (tmp_path / "benchmark" / "architectures" / "toy.py").write_text("TINY = {'base_channels': 4}\n")
    assert manifest.architecture({"architecture": "toy"}, root=tmp_path).TINY == {"base_channels": 4}


TOY = '''"""A planted architecture: the U-Net's reference and port at sizes of its
own, and no int8 lane: its control is the reference in fp8."""

import torch

from benchmark.drivers.common import ray_angles
from benchmark.reference.unet import EfficientUNet

TINY = {"resolution": [16, 64], "base_channels": 4, "channel_multiplier": [1, 2, 2, 4],
        "num_residual_blocks": [1, 1, 1, 1], "gn_num_groups": 2, "attn_num_heads": 1}
GAINS = ("norm1.weight", "norm.weight")
CONTROLS = {"chain": "fp8", "closed_loop": "fp8", "train": "fp8"}


def reference_net(cfg):
    return EfficientUNet(in_channels=cfg["in_channels"], resolution=tuple(cfg["resolution"]),
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
    return []
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
    new files (its module, configuration and one cell a driver) and new
    entries in ``BENCHMARK.json``; no file of the harness is edited."""
    root = tmp_path_factory.mktemp("planted")
    shutil.copy(manifest.ROOT / "BENCHMARK.json", root)
    shutil.copytree(manifest.HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(manifest.ROOT / "r2dm_tpu_torch", root / "r2dm_tpu_torch")
    bench = root / "benchmark"
    (bench / "architectures" / "toy.py").write_text(TOY)
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
        for e in m["end_to_end"]:
            if w["name"] in e.get("workloads", []):
                e["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    return root, cells


@pytest.mark.parametrize("driver", ["chain", "closed_loop", "train"])
def test_a_planted_architecture_runs_every_driver(planted, driver):
    root, cells = planted
    assert not (manifest.HERE / "architectures" / "toy.py").exists()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", RUN_TOY, cells[driver]], cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["architecture"] == "toy" and got["base_channels"] == 4
    assert got["correct"] and got["attempted"] > 0
    assert got["metrics"] == got["reported"]
    assert not got["half_batch_correct"] and got["flops"] > 0
    assert got["control"] == "fp8" and not got["control_correct"], got["control_checks"]
    assert got["int8"] != "ran"  # refused: the toy's network has no int8 lane, and training's control is fp8
