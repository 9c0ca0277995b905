"""Relative quality of few-step rectified-flow sampling, before and after
reflow: teacher euler-32/2/1 and reflowed euler-2/1.

    python -m r2dm_tpu_torch.flow_quality_check [workdir] [num_samples] [--device cuda|cpu]
    R2DM_FLOWQ_SMOKE=1 python -m r2dm_tpu_torch.flow_quality_check /tmp/q 8 --device cpu

The port of ``tools/flow_quality_check.sh``: train a rectified-flow model on
synthetic data (``python -m r2dm_tpu_torch.train --diffusion.timestep_type
flow``), 2-rectify it (``python -m r2dm_tpu_torch.reflow`` with
``reflow_args``, skipped when ``reflowed.msgpack`` exists), sample the same
seeds for each of ``LEGS`` with euler (``sample_and_save``), evaluate each
against the synthetic real set with random extractors, and print the gap
table as one JSON object under ``KEY``. A working reflow shows as reflowed
euler-1/2 rows that close most of the gap between the teacher's euler-1/2
and euler-32 rows; random-extractor numbers are not comparable to published
ones.

The working directory defaults to ``$TMPDIR/r2dm_flow_quality`` (``/tmp``
without ``$TMPDIR``), the sample count to 64. ``R2DM_FLOWQ_SMOKE=1`` runs
the same path at toy sizes (a 16x128, base-8 network, 60 train steps, 64
reflow pairs) on ``--device``; ``R2DM_QUALITY_REFLOW_STEPS`` sets the full-
size reflow's fine-tune steps (default 1000). The train gate, the caches and
the other knobs are ``quality.py``'s.
"""

from __future__ import annotations

import json
import os
import sys

from . import quality

KEY = "flow_few_step_random_extractors"
# (checkpoint, tag, euler steps): the teacher's full chain first
LEGS = [("teacher", "teacher_euler32", 32), ("teacher", "teacher_euler2", 2), ("teacher", "teacher_euler1", 1),
        ("reflow", "reflow_euler2", 2), ("reflow", "reflow_euler1", 1)]


def reflow_args(smoke: bool) -> list:
    if smoke:
        return ["--num_pairs", "64", "--teacher_steps", "8", "--batch_size", "8", "--train_steps", "30"]
    return ["--num_pairs", "1024", "--teacher_steps", "32", "--batch_size", "32",
            "--train_steps", os.environ.get("R2DM_QUALITY_REFLOW_STEPS") or "1000"]


def main(argv=None, run: quality.Leg = quality.run_leg) -> int:
    args = quality.parse_args(argv, "flow_quality_check", __doc__.split("\n\n")[0], "r2dm_flow_quality")
    smoke = os.environ.get("R2DM_FLOWQ_SMOKE") == "1"
    size = quality.sizes(smoke)
    proto = quality.Protocol(args.workdir, args.num_samples, args.device, run)
    if not proto.train_gate(size, ["--diffusion.timestep_type", "flow"]):
        return 0
    reflowed = os.path.join(args.workdir, "reflowed.msgpack")
    if not os.path.exists(reflowed):
        proto.leg("reflow", ["--ckpt", proto.ckpt, "--out", reflowed, *reflow_args(smoke)])
    ckpts = {"teacher": proto.ckpt, "reflow": reflowed}
    for which, tag, steps in LEGS:
        proto.sample_eval(ckpts[which], tag, steps, "euler", size.sample_batch)
    tags = [tag for _, tag, _ in LEGS]
    print(json.dumps(quality.summary(args.workdir, args.num_samples, tags, KEY), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
