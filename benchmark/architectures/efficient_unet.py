"""R2DM's EfficientUNet: what the harness needs of the architecture.

Found by ``manifest.architecture`` from a configuration file whose
``architecture`` is ``efficient_unet``. The reference network is
``reference/unet.py``'s; the port's is ``r2dm_tpu_torch.models.efficient_unet``,
built by ``build_model`` from the fields ``program_model`` sets.
"""

from __future__ import annotations

import torch

from benchmark.drivers.common import ray_angles
from benchmark.reference.unet import EfficientUNet
from benchmark.roofline import PEAK_FP32_FLOPS, kernels

# the CPU tests' cut: a few channels at 16 x 64
TINY = {"resolution": [16, 64], "base_channels": 8, "channel_multiplier": [1, 2, 2, 2],
        "num_residual_blocks": [1, 1, 1, 1], "gn_num_groups": 4, "attn_num_heads": 2}
# parameter names of the GroupNorm gains, drawn as 1 + 0.1 z
GAINS = ("norm1.weight", "norm.weight")
# the control of each driver: the port's int8 lane where it samples, the
# reference in fp8 where it trains (the lane raises under autograd)
CONTROLS = {"chain": "int8", "closed_loop": "int8", "train": "fp8"}
FIR_TAPS = 16


def reference_net(cfg: dict) -> torch.nn.Module:
    return EfficientUNet(in_channels=cfg["in_channels"], resolution=tuple(cfg["resolution"]),
                         base_channels=cfg["base_channels"], channel_multiplier=tuple(cfg["channel_multiplier"]),
                         num_residual_blocks=tuple(cfg["num_residual_blocks"]), gn_num_groups=cfg["gn_num_groups"],
                         gn_eps=cfg["gn_eps"], attn_num_heads=cfg["attn_num_heads"])


def extra_state(cfg: dict, device) -> dict:
    """The state beyond the parameters: ``coords``, the HDL-64E grid of ray
    angles, as the trainer and ``setup_model`` give the network."""
    return {"coords": ray_angles(cfg, device)}


def program_model(cfg: dict, m) -> None:
    """The port's ``Config.model`` fields of the configuration file."""
    m.architecture, m.base_channels = "efficient_unet", cfg["base_channels"]
    m.channel_multiplier = tuple(cfg["channel_multiplier"])
    m.num_residual_blocks = tuple(cfg["num_residual_blocks"])
    m.gn_num_groups, m.gn_eps, m.attn_num_heads = cfg["gn_num_groups"], cfg["gn_eps"], cfg["attn_num_heads"]
    m.coords_encoding = cfg["coords_encoding"]


def program_net():
    """The port's network class, whose forward the correctness check's
    faults patch."""
    from r2dm_tpu_torch.models.efficient_unet import EfficientUNet as Port

    return Port


def quantize(model: torch.nn.Module) -> int:
    """The control ``int8``: the port's int8 lane (``set_quant_conv``) on
    every quantizable ring conv of ``model``; how many it switched."""
    from r2dm_tpu_torch.models.layers import RingConv, set_quant_conv

    set_quant_conv(model, "w8a8")
    return sum(isinstance(m, RingConv) and m.quant == "w8a8" for m in model.modules())


def flops(cfg: dict) -> dict:
    """Operations of one forward of one image by kind (a multiply-add counts
    2): every 3x3 and 1x1 conv at its level's resolution (the down conv at the
    resolution it reads: the composed stride-2 6x6 form costs the same), the
    depthwise 4x4 FIR filters of the 2x resampling, the packed projections
    and the two products of each self-attention block, and the dense layers
    (time embedding, AdaGN projections)."""
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


def wrapped_work() -> list:
    """The port's callables whose calls the traced chain attributes, each
    with the least seconds of a call's work: the 3x3 ring conv of every
    ResidualBlock (the hand-written conv kernel) and the fused GroupNorm."""
    from r2dm_tpu_torch.models import layers

    def ringconv(args, y):
        h = args[2]
        B, H, W, C = h.shape
        return kernels.least_seconds(*kernels.ringconv(B, H, W, C, y.shape[-1], h.element_size(), y.element_size()))

    def group_norm(args, y):
        x = args[0]
        return kernels.least_seconds(*kernels.group_norm(x.numel(), x.element_size(), y.element_size()),
                                     PEAK_FP32_FLOPS)

    return [(layers.ResidualBlock, "_conv", "ringconv", ringconv),
            (layers, "fused_group_norm_silu", "group_norm", group_norm)]


def wrapped_probes() -> dict:
    """Each wrapped work's probes, by label: the arguments and result of a
    call at a level-1 shape at b8 (64 x 1024, 64 channels in, 128 out), the
    result in bfloat16 and in float32, as meta tensors."""
    h = torch.empty(8, 64, 1024, 64, dtype=torch.bfloat16, device="meta")
    y, y32 = (torch.empty(8, 64, 1024, 128, dtype=d, device="meta") for d in (torch.bfloat16, torch.float32))
    return {label: [((h, h, h), y), ((h, h, h), y32)] for label in ("ringconv", "group_norm")}


def _ceil_log2(n: int) -> int:
    return (n - 1).bit_length()
