"""Relative quality of the few-step samplers: 32-step DDIM and DPM-Solver++(2M)
against the 256-step DDPM chain.

    python -m r2dm_tpu_torch.ddim_quality_check [workdir] [num_samples] [--device cuda|cpu]
    R2DM_DDIMQ_SMOKE=1 python -m r2dm_tpu_torch.ddim_quality_check /tmp/q 8 --device cpu

The port of ``tools/ddim_quality_check.sh``: train a short synthetic run
(``python -m r2dm_tpu_torch.train``), sample the same seeds with each of
``SPECS`` (``sample_and_save``), evaluate each leg against the synthetic real
set with random extractors (``evaluate --allow_random_extractors``), and
print the FRD/FPD/BEV gap table as one JSON object under ``KEY``. Random-
extractor numbers are not comparable to published ones: only the gap
between rows (the same seeds and extractors) means something.

The working directory defaults to ``$TMPDIR/r2dm_ddim_quality`` (``/tmp``
without ``$TMPDIR``), the sample count to 64. ``R2DM_DDIMQ_SMOKE=1`` runs
the same path at toy sizes (a 16x128, base-8 network, 60 train steps, the
chains of ``SMOKE_SPECS``) on ``--device``. The train gate, the caches and
the other knobs are ``quality.py``'s.
"""

from __future__ import annotations

import json
import os
import sys

from . import quality

KEY = "few_step_vs_full_chain_random_extractors"
SPECS = [(256, "ddpm"), (32, "ddim"), (32, "dpmpp_2m")]  # (steps, mode): the full chain first
SMOKE_SPECS = [(8, "ddpm"), (4, "ddim"), (4, "dpmpp_2m")]


def main(argv=None, run: quality.Leg = quality.run_leg) -> int:
    args = quality.parse_args(argv, "ddim_quality_check", __doc__.split("\n\n")[0], "r2dm_ddim_quality")
    smoke = os.environ.get("R2DM_DDIMQ_SMOKE") == "1"
    size = quality.sizes(smoke)
    proto = quality.Protocol(args.workdir, args.num_samples, args.device, run)
    if not proto.train_gate(size):
        return 0
    tags = []
    for steps, mode in SMOKE_SPECS if smoke else SPECS:
        tags.append(f"{mode}{steps}")
        proto.sample_eval(proto.ckpt, tags[-1], steps, mode, size.sample_batch)
    print(json.dumps(quality.summary(args.workdir, args.num_samples, tags, KEY), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
