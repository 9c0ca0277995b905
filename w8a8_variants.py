#!/usr/bin/env python3
"""Named variants of the int8 lane's CUDA source, timed on one NVIDIA card.

    python3 w8a8_variants.py [name ...]     # every variant when none is named

Each variant is a list of text edits of ``r2dm_tpu_torch/csrc/w8a8_ringconv.cu``,
built with the port's nvcc flags (one process each, in parallel) into
``_ab/w8a8_variants/`` and loaded in turn in place of the port's library.
At every site shape the int8 lane serves in a config-H b8 forward (phase 14 of
chip_smoke.py) the script times the s8 conv alone and the quantize pass
(CUDA-graph replay), says whether the conv's output still equals the plain
version (an ablation that drops work will not), and prints one JSON line per
site and the sums over the 53 sites of a forward. The card's name and power
limit come first. The design choices the source note of the kernel gives
numbers for are the variants below.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

SRC = "r2dm_tpu_torch/csrc/w8a8_ringconv.cu"
OUT_DIR = os.path.join("_ab", "w8a8_variants")
STAGED_STORE = "      const int p = i / VPR, v = i % VPR;\n      if (w0 + p < W)"
PRODUCTS = ("          wgmma_m64n64k32_s8(acc[mt], da0 + st16 + mt * 64 + tap + kk * 2 * A_ROWS,\n"
            "                             db0 + st16 + tap * (B_TAP_BYTES / 16) + kk * 2 * B_ROWS);")
# name -> [(text, replacement), ...]; "v2" is the source as it stands
VARIANTS = {
    "v2": [],
    # the epilogue stored from the wgmma fragments (16-byte pieces of 8 lines a warp store)
    "fragment-stores": [("  if (F % BN == 0) {\n", "  if (F < 0) {\n")],
    # 128-pixel tiles at every W (4 stages)
    "bm128": [("return W >= 256 ?", "return W >= (1 << 30) ?")],
    # the 256-pixel tile with 4 stages (one block an SM)
    "bm256-s4": [("static constexpr int S = MT == 1 ? 4 : 3;", "static constexpr int S = 4;")],
    # 3 stages for the 128-pixel tile too
    "bm128-s3": [("static constexpr int S = MT == 1 ? 4 : 3;", "static constexpr int S = 3;")],
    # copies that skip L1
    "cg": [("cp.async.ca.shared.global", "cp.async.cg.shared.global")],
    # ablations (wrong output): no output stores, no products, no x copies, no weight copies
    "no-stores": [(STAGED_STORE, STAGED_STORE[:-1] + " && H < 0)")],
    "no-products": [(PRODUCTS, "          (void)0;")],
    "no-x-copies": [("          const bool ok = w0 + r < Wp;", "          const bool ok = false;")],
    "no-weight-copies": [("          const bool ok = n0 + n < F;\n          const int8_t* src",
                          "          const bool ok = false;\n          const int8_t* src")],
}


def build_variants(names, build):
    source = open(SRC).read()
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        path = os.path.join(OUT_DIR, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{out[-3000:]}")
        lib = ctypes.CDLL(os.path.abspath(os.path.join(OUT_DIR, f"{name}.so")))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("w8a8_variants: no CUDA device; this script runs on an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from r2dm_tpu_torch.bench import card, random_ddpm
    from r2dm_tpu_torch.models import layers
    from r2dm_tpu_torch.ops import build, quant

    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    print(card())
    libs = build_variants(names, build)
    net = random_ddpm().model
    x = cs.randn(torch, (cs.B, 64, 1024, 2), 30)
    cond = torch.linspace(-5.0, 5.0, cs.B, device="cuda")
    layers.set_quant_conv(net, "w8a8")
    sites = cs._lane_sites(torch, net, x, cond)
    layers.set_quant_conv(net, None)
    unique = {}
    for s in sites:
        unique[s] = unique.get(s, 0) + 1
    total = {}
    for i, ((shape, x_dtype, f, out_dtype), count) in enumerate(unique.items()):
        c = shape[3]
        x = cs.randn(torch, shape, 31 + i, x_dtype, scale=1.5)
        k = cs.randn(torch, (3, 3, c, f), 50 + i, scale=(9 * c) ** -0.5)
        bias = cs.randn(torch, (f,), 70 + i, scale=0.1)
        packed = quant.pack_weight(k)
        row = {"shape": list(shape), "f": f, "per_forward": count}
        with torch.inference_mode():
            amax = quant.act_absmax(x)
            ref = quant.ring_conv_w8a8_plain(x, k, bias, out_dtype)
            for name, lib in libs.items():
                build._libs["w8a8_ringconv"] = lib
                lib.w8a8_ringconv_launch.argtypes = None  # quant._lib() declares them again
                quant._lib()
                xq = quant.act_quantize(x, amax)
                same = torch.equal(quant.ring_conv_s8(xq, amax, packed, bias, out_dtype), ref)
                ms = cs.graph_ms(torch, lambda: quant.ring_conv_s8(xq, amax, packed, bias, out_dtype))
                q_ms = cs.graph_ms(torch, lambda: quant.act_quantize(x, amax))
                row[name] = {"conv_ms": ms, "quantize_ms": q_ms, "equal_to_plain": same}
                total.setdefault(name, {"conv_ms": 0.0, "quantize_ms": 0.0})
                total[name]["conv_ms"] += ms * count
                total[name]["quantize_ms"] += q_ms * count
        print(json.dumps(row))
    build._libs.pop("w8a8_ringconv", None)
    print(f"sums over the {len(sites)} sites of a b{cs.B} forward: {json.dumps(total)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
