"""Operations of one forward of one image, from a configuration's sizes
(a multiply-add counts 2).

``efficient_unet``: every 3x3 and 1x1 conv at its level's resolution (the
down conv at the resolution it reads: the composed stride-2 6x6 form costs
the same), the depthwise 4x4 FIR filters of the 2x resampling, the packed
projections and the two products of each self-attention block, and the dense
layers (time embedding, AdaGN projections).

``refinenet``: every convolution, each at its output's resolution: the
reference network's convs are walked on the meta device, so no memory is
touched and no weight is needed.
"""

from __future__ import annotations

import torch

FIR_TAPS = 16


def efficient_unet(cfg: dict) -> dict:
    H, W = cfg["resolution"]
    base, mult, blocks = cfg["base_channels"], cfg["channel_multiplier"], cfg["num_residual_blocks"]
    cin = cfg["in_channels"]
    temb = 4 * base
    ff = 2 * (_ceil_log2(H) + _ceil_log2(W))
    C = [base] + [base * m for m in mult]

    def conv(ci, co, h, w, k=3):
        return 2 * h * w * ci * co * k * k

    out = {"conv": conv(cin + ff, C[0], H, W) + conv(C[0], cin, H, W), "resample": 0, "attention": 0,
           "dense": 2 * (base * temb + temb * temb)}
    h, w = H, W
    # (in, out, blocks, down, up, attn) of the eight levels, in order
    levels = [(C[0], C[1], blocks[0], False, False, False), (C[1], C[2], blocks[1], True, False, False),
              (C[2], C[3], blocks[2], True, False, False), (C[3], C[4], blocks[3], True, False, True),
              (C[4], C[3], blocks[3], False, True, True), (2 * C[3], C[2], blocks[2], False, True, False),
              (2 * C[2], C[1], blocks[1], False, True, False), (2 * C[1], C[0], blocks[0], False, False, False)]
    for ci, co, n, down, up, attn in levels:
        if down:
            out["conv"] += conv(ci, co, h, w)
            h, w = h // 2, w // 2
            out["resample"] += 2 * h * w * co * FIR_TAPS
            ci = co
        for i in range(n):
            c_in = ci if i == 0 else co
            out["conv"] += conv(c_in, co, h, w) + conv(co, co, h, w)
            if c_in != co:
                out["conv"] += conv(c_in, co, h, w, 1)
            out["dense"] += 2 * temb * 2 * co
        if attn:
            t = h * w
            out["attention"] += 2 * t * 3 * co * co + 2 * 2 * t * t * co + 2 * t * co * co
        if up:
            h, w = 2 * h, 2 * w
            out["resample"] += 2 * h * w * co * FIR_TAPS
            out["conv"] += conv(co, co, h, w)
    return out


def refinenet(cfg: dict) -> dict:
    from ..reference.refinenet import RefineNet

    H, W = cfg["resolution"]
    total = []
    with torch.device("meta"):
        net = RefineNet(cfg["in_channels"], (H, W), cfg["base_channels"], cfg["channel_multiplier"])
        hooks = [m.register_forward_hook(
            lambda m, a, y: total.append(2 * y[0, 0].numel() * m.weight.numel()))
            for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
        net(torch.zeros(1, H, W, cfg["in_channels"]))
    for hk in hooks:
        hk.remove()
    return {"conv": sum(total)}


def forward_flops(cfg: dict) -> int:
    """All the operations of one forward of one image."""
    kind = {"efficient_unet": efficient_unet, "refinenet": refinenet}[cfg["architecture"]]
    return sum(kind(cfg).values())


def _ceil_log2(n: int) -> int:
    return (n - 1).bit_length()
