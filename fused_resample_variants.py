#!/usr/bin/env python3
"""Lowerings of the composed down conv (conv∘FIR) on one NVIDIA card.

    python3 fused_resample_variants.py [--batches 1,2,3,...,512] [--no-time] [--no-network]

At each config-H down shape (the input of d_block2, d_block3, d_block4)
and batch, each lowering of the main conv of
``r2dm_tpu_torch/ops/fused_resample.py::conv_then_downsample`` and the op
as the network calls it, each with its device time (CUDA-graph replay,
``chip_smoke.graph_ms``) and three witnesses of its rounding:

  row_diff    max|diff| of the output when the batch is rolled by one and
              when it is reversed, each permuted back: 0 when a sample's
              result does not depend on its row in the batch (what a
              data-parallel run that strides the seeds over ranks needs to
              reproduce one rank's samples)
  alone_diff  max|diff| of the first, middle and last sample computed in
              the batch and alone (batch 1): 0 when a sample's result does
              not depend on the batch size
  run_diff    max|diff| of two calls on the same batch: 0 when the result
              does not change from one call to the next

The lowerings:

  stride2_6x6  cuDNN's stride-2 6x6 conv on the (2, 3)-padded input
  cells_conv   the same sums as one 3x3 cuDNN conv over the batch on 2x2
               cells (4 C_in channels), one cell of padding a side
  cells_pad3   the same conv on cells padded by (1, 2), its last output
               row and column dropped
  cells_gemm   the same sums as im2col of the cells and one cuBLAS product
               (left out where its im2col would pass ``GEMM_BYTES``)
  per_sample   the 3x3 cuDNN conv one sample a call (``_cells_cudnn``, the
               card's lowering; left out above ``PER_SAMPLE_MAX_BATCH``)
  first_version  (network only) ``cells_pad3``, or its matrix product
               where the output pixels are fewer than the reduction
  shipped      ``conv_then_downsample`` as the network calls it
  two_op       the ring conv, then the FIR downsample (FUSED_RESAMPLE off)

Then (unless ``--no-network``) the same row and batch-size witnesses for
a whole config-H forward at b8 (random weights from a seed), the network
built with each lowering in turn as its down conv, and with the two-op
down path.

The default batches are the sizes the port's entry points hand the
network: 1 to 8 (``generate``, ``completion_demo``, a rank of a strided
``sample_and_save``), the powers of two up to the sampler's chunk at
config H (512 images, ``DDPM.MAX_BATCH_PIXELS``) with ``bench``'s 256,
and sizes between them. bf16, random inputs from a seed. Prints the
card's name and power limit, then one JSON line a shape and batch.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

DOWN_SHAPES = [(64, 128, 64, 1024), (128, 256, 32, 512), (256, 512, 16, 256)]
BATCHES = "1,2,3,4,5,6,8,12,16,24,32,48,64,96,128,192,256,384,512"
GEMM_BYTES = 8 << 30  # the im2col matrix of cells_gemm, at most
PER_SAMPLE_MAX_BATCH = 256  # per_sample's launches grow with the batch


def witnesses(torch, fn, x) -> dict:
    """row_diff, alone_diff and run_diff of ``fn`` on the batch ``x``."""
    b = x.shape[0]
    y = fn(x).float()
    row = 0.0
    for perm in (torch.roll(torch.arange(b, device=x.device), 1), torch.arange(b - 1, -1, -1, device=x.device)):
        row = max(row, (y[perm] - fn(x[perm]).float()).abs().max().item())
    alone = max((y[i:i + 1] - fn(x[i:i + 1]).float()).abs().max().item() for i in sorted({0, b // 2, b - 1}))
    return {"row_diff": row, "alone_diff": alone, "run_diff": (y - fn(x).float()).abs().max().item()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", default=BATCHES, help="comma-separated batch sizes")
    parser.add_argument("--no-time", dest="time", action="store_false", help="the witnesses only")
    parser.add_argument("--no-network", dest="network", action="store_false", help="the convs only")
    args = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("fused_resample_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from r2dm_tpu_torch.ops import fused_resample as fr
    from r2dm_tpu_torch.ops.pad import ring_pad
    from r2dm_tpu_torch.ops.resample import fir_kernel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    fir = fir_kernel().to("cuda", torch.bfloat16)

    s2d = fr._s2d_cells

    def cells_pad3(t):  # x's 2x2 cells, ring padded by (1, 2) in W and zero padded by (1, 2) in H
        cells = s2d(t)
        return torch.cat([F.pad(cells, (0, 0, 0, 0, 0, 1)), F.pad(cells[:, :, 2:3], (0, 0, 0, 0, 0, 1))], dim=2)

    def batched(cells, weight):  # one cuDNN conv over the batch, NHWC
        return F.conv2d(cells.permute(0, 3, 1, 2), weight).permute(0, 2, 3, 1)

    def conv_pad3(cells, weight):  # the valid conv of the (1, 2)-padded cells, its first Hs x Ws outputs
        return batched(cells, weight)[:, :-1, :-1]

    def first_version(cells, weight):  # on the (1, 2)-padded cells, the product where pixels < reduction
        B, Hp, Wp, C4 = cells.shape
        if B * (Hp - 3) * (Wp - 3) < 9 * C4:
            return fr._cells_matmul(cells, weight)[:, :-1, :-1]
        return conv_pad3(cells, weight)

    for (C, Fo, H, W) in DOWN_SHAPES:
        g = torch.Generator("cuda").manual_seed(0)
        k = (torch.randn((3, 3, C, Fo), generator=g, device="cuda") * (9 * C) ** -0.5).to(torch.bfloat16)
        bias = torch.randn((Fo,), generator=g, device="cuda") * 0.1
        weight = fr.down_weight(k)
        w6 = fr._composed_kernel(k, 1.0).permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        forms = {
            "stride2_6x6": lambda t: F.conv2d(ring_pad(t, (2, 3, 2, 3)).permute(0, 3, 1, 2), w6, stride=2),
            "cells_conv": lambda t: batched(s2d(t), weight),
            "cells_pad3": lambda t: conv_pad3(cells_pad3(t), weight),
            "cells_gemm": lambda t: fr._cells_matmul(s2d(t), weight),
            "per_sample": lambda t: fr._cells_cudnn(s2d(t), weight),
            "shipped": lambda t: fr.conv_then_downsample(t, k, bias, weight=weight),
            "two_op": lambda t: cs._two_op_down(torch, t, k, bias, fir),
        }
        for b in (int(v) for v in args.batches.split(",")):
            g = torch.Generator("cuda").manual_seed(1)
            x = torch.randn((b, H, W, C), generator=g, device="cuda").to(torch.bfloat16)
            pixels = b * (H // 2) * (W // 2)
            rec = {"cin": C, "f": Fo, "h": H, "w": W, "b": b, "pixels": pixels, "reduction": 36 * C}
            with torch.inference_mode():
                for name, fn in forms.items():
                    if (name == "cells_gemm" and pixels * 36 * C * 2 > GEMM_BYTES) or \
                            (name == "per_sample" and b > PER_SAMPLE_MAX_BATCH):
                        continue
                    rec[name] = witnesses(torch, fn, x)
                    if args.time:
                        rec[name]["ms"] = cs.graph_ms(torch, lambda: fn(x))
            print(json.dumps(rec), flush=True)
            del x
            torch.cuda.empty_cache()

    if args.network:
        from r2dm_tpu_torch.bench import random_ddpm

        model = random_ddpm(seed=1).model
        g = torch.Generator("cuda").manual_seed(2)
        x = torch.randn((cs.B, 64, 1024, 2), generator=g, device="cuda")
        t = torch.full((cs.B,), 0.5, device="cuda")  # one time for every sample, so a permuted batch keeps it
        lowerings = {
            "cells_conv": (s2d, batched),
            "cells_pad3": (cells_pad3, conv_pad3),
            "first_version": (cells_pad3, first_version),
            "cells_gemm": (s2d, fr._cells_matmul),
            "shipped": (s2d, fr._cells_conv),
        }
        rec = {"b": cs.B}
        shipped_conv = fr._cells_conv
        for name, (cells_fn, conv_fn) in lowerings.items():
            fr._s2d_cells, fr._cells_conv = cells_fn, conv_fn
            try:
                with torch.inference_mode():
                    rec[name] = witnesses(torch, lambda v: model(v, t[:v.shape[0]]), x)
            finally:
                fr._s2d_cells, fr._cells_conv = s2d, shipped_conv
        from r2dm_tpu_torch.models import layers

        layers.FUSED_RESAMPLE = False
        with torch.inference_mode():
            rec["two_op"] = witnesses(torch, lambda v: model(v, t[:v.shape[0]]), x)
        layers.FUSED_RESAMPLE = "down"
        print("network b%d forward: %s" % (cs.B, json.dumps(rec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
