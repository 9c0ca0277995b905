"""Run one cell of the benchmark of ``r2dm_tpu_torch`` on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its traffic file ``benchmark/workloads/<cell>.json``
names the driver (``benchmark/drivers/<driver>.py``) and its parameters, and
the configuration file the network's sizes. With ``--trace 0`` the last line
of standard output is the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (``benchmark/metrics/<metric>.py``) and a breakdown; every
run checks what the timed path produced against the plain reference and
prints each number compared beside its limit, on standard error and last in
the result line. Without a card, or with fewer than the cell asks for, it
exits 2 and prints no result; if the JAX package or JAX was loaded, 3.

``--control int8|bf16|fp8`` runs the correctness check's control in the
program's place (the program's int8 lane for the network, the reference's
bfloat16 sampler steps and conversion, the reference in fp8 for training);
the timed runs never pass it.
"""

import os
import time


def _process_start() -> float:
    """The host clock (perf_counter) at which this process started."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "r2dm_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("int8", "bf16", "fp8"), default=None)
    return p.parse_args(argv)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def number(v: float) -> float:
    """A JSON number: an infinite or undefined reading as the largest double."""
    return v if math.isfinite(v) else 1.7976931348623157e308


def result(manifest: dict, cell: dict, outcome, trace: bool, device) -> dict:
    import torch

    from . import manifest as mf

    if trace:
        metrics = {}
        for m in mf.per_layer(manifest, cell["name"]):
            value = mf.reader(m["name"])(outcome.observed)
            if value is not None:
                metrics[m["name"]] = {"value": number(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": number(outcome.metrics[m["name"]]), "unit": m["unit"]}
                   for m in mf.end_to_end(manifest, cell["name"]) if m["name"] in outcome.metrics}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell["chips"],
           "memory_peak_bytes": outcome.peak}
    out = {"correct": all(math.isfinite(v) and v <= lim for v, lim in outcome.checks.values()),
           "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": dev}
    profile = outcome.observed.get("profile")
    if trace and profile is not None:
        dev["busy_s"], dev["window_s"] = profile.busy_s, profile.window_s
        labelled = outcome.observed.get("profile_host", profile)
        out["breakdown"] = {"device_ops": profile.device_ops, "idle_gaps": labelled.idle_gaps}
    out["checks"] = {k: {"value": number(v), "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from . import manifest as mf

    manifest = mf.load()
    cell = mf.cell(manifest, args.workload)
    traffic = mf.traffic(cell["name"])
    cfg = mf.config(manifest, cell["config"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from .drivers.common import Context, log

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = Context(cell=cell["name"], seed=args.seed, seconds=args.seconds, trace=bool(args.trace), cfg=cfg,
                  traffic=traffic, device=device, t_start=T_START, control=args.control)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    outcome = driver.run(ctx)
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    found = forbidden_modules()
    if found:
        print(f"the run loaded JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        return 3
    line = result(manifest, cell, outcome, ctx.trace, device)
    for name, c in line["checks"].items():
        ok = c["value"] <= c["limit"]
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) {'ok' if ok else 'FAILED'}", file=sys.stderr,
              flush=True)
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
