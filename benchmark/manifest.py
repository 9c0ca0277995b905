"""``BENCHMARK.json`` and the files it names, found by name.

A cell's traffic mix is ``workloads/<cell>.json``, its configuration
``configs/<config>.json`` (the manifest's ``file``), the network of a
configuration ``architectures/<architecture>.py`` (the file's
``architecture``), and each per-layer metric ``metrics/<metric>.py``, whose
``read(observed)`` returns the number or None. Nothing here knows a cell, a
configuration, an architecture or a metric by name.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(HERE / "workloads" / f"{name}.json") as f:
        return json.load(f)


def end_to_end(manifest: dict, cell_name: str) -> list[dict]:
    return [m for m in manifest["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer(manifest: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics the cell reports: those that list it, and those
    without a list that move an end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def architecture(cfg: dict, root: Path = ROOT):
    """``benchmark/architectures/<architecture>.py`` of the checkout at
    ``root``, for a configuration file: all that the harness knows of a
    network. It gives

    - ``TINY``: the sizes the CPU tests cut the configuration to;
    - ``GAINS``: the suffixes of the parameter names that ``weights.py``
      draws as a norm's gain;
    - ``CONTROLS``: the correctness check's control of each driver (``int8``,
      the program's own int8 lane; ``fp8``, the reference in fp8 in the
      program's place);
    - ``reference_net(cfg)``: the plain reference network (``reference/``),
      whose ``set_quant("fp8")`` computes it in the control's precision;
    - ``extra_state(cfg, device)``: the state the benchmark's weights carry
      beyond the parameters;
    - ``program_model(cfg, m)``: sets the port's ``Config.model`` fields;
    - ``program_net()``: the port's network class;
    - ``quantize(model)``, where the port's network has an int8 lane: turns
      it on and returns how many modules it switched;
    - ``flops(cfg)``: the operations of one forward of one image, by kind;
    - ``wrapped_work()``: the port's callables the traced chain attributes,
      as ``(owner, attribute, label, least seconds of a call's work)``;
    - ``wrapped_probes()``: for each label of ``wrapped_work``, the
      ``(args, result)`` meta tensors its work is frozen on
      (``tests/readings.py``), at two result dtypes.
    """
    name = cfg["architecture"]
    path = root / "benchmark" / "architectures" / f"{name}.py"
    if not NAME.match(name) or not path.is_file():
        raise KeyError(f"configuration {cfg.get('name')!r} names the architecture {name!r}, and there is no {path}")
    return _architecture(name, path)


@functools.cache
def _architecture(name: str, path: Path):
    """One module object per file, however often a run looks it up."""
    return _module(f"benchmark.architectures.{name.replace('.', '_')}", path)


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    return _module(f"benchmark.metrics.{metric.replace('.', '_')}", HERE / "metrics" / f"{metric}.py").read


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
