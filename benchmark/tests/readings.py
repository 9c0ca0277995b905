"""The readings that ``test_architectures.py`` holds frozen, and the files
they are frozen in.

``frozen/configs/<config>.json`` holds a configuration's: the benchmark's
weights leaf by leaf at its architecture module's tiny sizes (a sha256 of
each leaf's bytes, on the CPU, drawn from the one seed of
``frozen/seed.json``), the parameters' count, size and names and shapes at
full size, the fields of the port's ``Config`` that the harness sets (every
other field is the port's own default), and the operations of a forward at
both sizes. ``frozen/architectures/<architecture>.json`` holds an
architecture's callables that the traced chain attributes, each with the
least seconds of its work on the module's ``wrapped_probes()``.

A configuration whose files are missing gets them from the harness as it
stands::

    python -m benchmark.tests.readings <config> [<config> ...]

which writes the missing files of those configurations and of their
architectures, and never overwrites one. The program's ``Config`` fields it
freezes are those that differ from the port's defaults.
"""

from __future__ import annotations

import hashlib
import json
import sys
from dataclasses import asdict
from pathlib import Path

import torch

from benchmark import manifest, weights
from benchmark.drivers.common import program_config
from benchmark.roofline import flops

FROZEN = Path(__file__).resolve().parent / "frozen"


def seed() -> int:
    return json.loads((FROZEN / "seed.json").read_text())["seed"]


def config_file(name: str) -> Path:
    return FROZEN / "configs" / f"{name}.json"


def architecture_file(name: str) -> Path:
    return FROZEN / "architectures" / f"{name}.json"


def plain(x):
    return json.loads(json.dumps(x))


def tiny(cfg: dict) -> dict:
    return plain(dict(cfg, **manifest.architecture(cfg).TINY))


def tiny_leaves(cfg: dict) -> list:
    """[name, sha256 of the leaf's bytes] of the weights at the tiny sizes."""
    sd = weights.make_state_dict(tiny(cfg), seed(), "cpu")
    return [[n, hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()] for n, t in sd.items()]


def shapes(cfg: dict) -> dict:
    with torch.device("meta"):
        got = [[n, list(p.shape)] for n, p in weights.reference_net(cfg).named_parameters()]
    return {"parameters": len(got), "numel": sum(torch.Size(s).numel() for _, s in got),
            "shapes_sha256": hashlib.sha256(json.dumps(got).encode()).hexdigest()}


def default_config() -> dict:
    from r2dm_tpu_torch.config import Config

    return plain(asdict(Config()))


def program_fields(cfg: dict) -> dict:
    """The port's ``Config`` of the configuration: by section, the fields
    that differ from the port's defaults."""
    got, default = plain(asdict(program_config(cfg))), default_config()
    return {s: {k: v for k, v in fields.items() if v != default[s][k]} for s, fields in got.items()
            if any(v != default[s][k] for k, v in fields.items())}


def config_readings(cfg: dict) -> dict:
    return {"tiny_leaves": tiny_leaves(cfg), **shapes(cfg),
            "forward_flops": flops.forward_flops(cfg), "forward_flops_tiny": flops.forward_flops(tiny(cfg)),
            "program_config": program_fields(cfg), "program_config_tiny": program_fields(tiny(cfg))}


def _owner(o) -> str:
    return o.__name__ if isinstance(o, type(sys)) else f"{o.__module__}.{o.__qualname__}"


def wrapped(arch) -> list:
    """[owner, attribute, label, [least seconds of the work on each probe]]
    of each callable the architecture module wraps."""
    probes = arch.wrapped_probes()
    return [[_owner(o), attr, label, [work(args, y) for args, y in probes[label]]]
            for o, attr, label, work in arch.wrapped_work()]


def dump(x, indent: int = 0) -> str:
    """JSON with a dict's keys a line each and a list of plain values on one line."""
    pad = " " * (indent + 1)
    if isinstance(x, dict) and x:
        items = [f"{pad}{json.dumps(k)}: {dump(v, indent + 1)}" for k, v in x.items()]
        return "{\n" + ",\n".join(items) + "\n" + " " * indent + "}"
    if isinstance(x, list) and any(isinstance(v, (dict, list)) for v in x):
        return "[\n" + ",\n".join(pad + dump(v, indent + 1) for v in x) + "\n" + " " * indent + "]"
    return json.dumps(x)


def main(argv: list) -> int:
    m = manifest.load()
    for name in argv:
        cfg = manifest.config(m, name)
        arch = manifest.architecture(cfg)
        for path, make in ((config_file(name), lambda: config_readings(cfg)),
                           (architecture_file(cfg["architecture"]), lambda: wrapped(arch))):
            if path.exists():
                print(f"{path} is there; left as it is")
                continue
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(dump(make()) + "\n")
            print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
