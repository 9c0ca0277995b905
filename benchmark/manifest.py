"""``BENCHMARK.json`` and the files it names, found by name.

A cell's traffic mix is ``workloads/<cell>.json``, its configuration
``configs/<config>.json`` (the manifest's ``file``), and each per-layer
metric ``metrics/<metric>.py``, whose ``read(observed)`` returns the number or
None. Nothing here knows a cell, a configuration or a metric by name.
"""

from __future__ import annotations

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


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
