"""Export a msgpack checkpoint of either package as a reference-layout
torch ``.pth``.

    python -m r2dm_tpu_torch.export_torch_ckpt checkpoint.msgpack out.pth

The counterpart of the repo's ``tools/export_torch_ckpt.py``: the
checkpoint (an EfficientUNet or a LiDARGen RefineNet, from either trainer)
is read with the port's own reader (``checkpoint.py``), and both lanes,
``weights`` and ``ema_weights`` (``weights`` again when there is no EMA),
are written under the reference's ``model.`` names, beside ``cfg`` and
``global_step``. Each lane holds every parameter and the ``coords`` buffer;
what the reference registers again when it builds the network (FIR
kernels, residual ``scale``, coordinate-encoding tables, ``_dummy``) is
left out, so the reference loads the file with ``strict=False``, and
``setup_model`` of either package reads it as it is.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .checkpoint import load_checkpoint
from .utils.weights import from_jax


def export(ckpt: dict) -> dict:
    """A loaded msgpack checkpoint -> the reference ``.pth`` dict."""
    arch = ckpt["cfg"].get("model", {}).get("architecture", "efficient_unet")

    def lane(tree) -> dict[str, torch.Tensor]:
        return {f"model.{k}": v for k, v in from_jax(tree, arch).items()}

    weights = lane(ckpt["weights"])
    return {
        "cfg": ckpt["cfg"],
        "weights": weights,
        "ema_weights": lane(ckpt["ema_weights"]) if ckpt.get("ema_weights") else weights,
        "global_step": ckpt.get("global_step", 0),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("ckpt", help="a msgpack checkpoint")
    parser.add_argument("out", help="the .pth to write")
    args = parser.parse_args(argv)
    out = export(load_checkpoint(args.ckpt))
    torch.save(out, args.out)
    print(f"wrote {args.out}: {len(out['weights'])} tensors/lane, step {out['global_step']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
