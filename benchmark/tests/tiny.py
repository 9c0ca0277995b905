"""Tiny versions of the cells, for the harness's CPU tests: the same drivers,
configurations cut to their architecture module's ``TINY`` sizes, short
windows."""

from __future__ import annotations

import json
import time

import torch

from benchmark import manifest
from benchmark.drivers.common import Context

TRAFFIC = {
    "chain": {"batch": 4, "steps": 8, "check_rows": 4, "check_steps": 2, "check_within": 3, "reference_rows": 2},
    "closed_loop": {"batch": 2, "steps": 4, "check_requests": 2, "check_within": 3, "reference_rows": 2},
    "train": {"pool_scans": 12, "reference_rows": 2},
}
CELLS = [w["name"] for w in manifest.load()["workloads"]]


def context(cell: str, seed: int = 2**33 + 17, seconds: float = 0.5, control=None) -> Context:
    m = manifest.load()
    entry = manifest.cell(m, cell)
    cfg = manifest.config(m, entry["config"])
    cfg = dict(cfg, **manifest.architecture(cfg).TINY)
    cfg["training"] = dict(cfg["training"], batch_size=4)
    traffic = manifest.traffic(cell)
    traffic = dict(traffic, **TRAFFIC[traffic["driver"]])
    return Context(cell=cell, seed=seed, seconds=seconds, trace=False, cfg=json.loads(json.dumps(cfg)),
                   traffic=traffic, device=torch.device("cpu"), t_start=time.perf_counter(), control=control)


def run(ctx):
    import importlib

    return importlib.import_module(f"benchmark.drivers.{ctx.traffic['driver']}").run(ctx)


def correct(outcome) -> bool:
    return all(v <= limit for v, limit in outcome.checks.values())
