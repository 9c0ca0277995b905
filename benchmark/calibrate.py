"""The readings a cell's limits are set from: the correctness check of many
seeds in one process, with the program or with the control in its place.

    python3 -m benchmark.calibrate --workload <cell> --seeds 11,12,13 --seconds 3 \
        [--control int8|bf16|fp8 | --fault unchanged_state|half_batch|altered_answer]

Each seed runs the cell's driver (set-up, a short window, the check) and
prints one JSON line of the numbers compared; ``--fault`` plants one of
``faults.py``'s faults under the program. The window's length does not
change what is compared, only how many steps or requests there are to draw
from; but the closed loop draws its checked requests among the window's first
``check_within``, so give it a window that sends that many (about 20 s): a
drawn request never sent reads as infinite. The timed runs never use this.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import time

import torch

from . import manifest as mf
from .drivers.common import Context, free, log
from .faults import FAULTS, plant
from .run import card_line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", choices=("int8", "bf16", "fp8"), default=None)
    p.add_argument("--fault", choices=FAULTS, default=None)
    args = p.parse_args(argv)
    m = mf.load()
    cell = mf.cell(m, args.workload)
    traffic, cfg = mf.traffic(cell["name"]), mf.config(m, cell["config"])
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    log(f"card: {card_line()}")
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        ctx = Context(cell=cell["name"], seed=seed, seconds=args.seconds, trace=False, cfg=cfg, traffic=traffic,
                      device=torch.device("cuda", 0), t_start=time.perf_counter(), control=args.control)
        with plant(args.fault, ctx) if args.fault else contextlib.nullcontext():
            out = driver.run(ctx)
        print(json.dumps({"cell": cell["name"], "seed": seed, "control": args.control, "fault": args.fault,
                          "attempted": out.attempted,
                          "checks": {k: v for k, (v, _) in out.checks.items()}}), flush=True)
        del out
        free(ctx.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
