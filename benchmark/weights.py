"""Random weights from the run's seed, made on the card in one draw.

The parameter names and shapes are the reference network's (the published
``state_dict`` names, which the program loads as they are). One standard
normal vector of all the parameters is drawn from a generator on ``device``
seeded with ``seed``, and each leaf is cut from it and scaled so that the
activations keep their size through the depth: a conv or dense weight by
1 / sqrt(fan-in), a norm's gain (GroupNorm weight, InstanceNorm++ alpha and
post-affine weight) as 1 + 0.1 z, every bias by 0.1. No leaf is zero, so every
gradient flows from the first step. ``coords`` is the HDL-64E grid of ray
angles, as the trainer and ``setup_model`` give the network.
"""

from __future__ import annotations

import math

import torch

from .reference.refinenet import RefineNet
from .reference.unet import EfficientUNet, hdl64e_angles

GAINS = ("norm1.weight", "norm.weight", "alpha", "post_affine.weight")


def reference_net(cfg: dict) -> torch.nn.Module:
    """The reference network of a configuration file's ``model`` sizes."""
    common = dict(in_channels=cfg["in_channels"], resolution=tuple(cfg["resolution"]),
                  base_channels=cfg["base_channels"], channel_multiplier=tuple(cfg["channel_multiplier"]))
    if cfg["architecture"] == "refinenet":
        return RefineNet(**common)
    return EfficientUNet(num_residual_blocks=tuple(cfg["num_residual_blocks"]), gn_num_groups=cfg["gn_num_groups"],
                         gn_eps=cfg["gn_eps"], attn_num_heads=cfg["attn_num_heads"], **common)


def make_state_dict(cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        shapes = [(n, tuple(p.shape)) for n, p in reference_net(cfg).named_parameters()]
    g = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, s in shapes), generator=g, device=device)
    sd, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if name.endswith(GAINS):
            sd[name] = 1.0 + 0.1 * z
        elif len(shape) >= 2:
            sd[name] = z / math.sqrt(n // shape[0])
        else:
            sd[name] = 0.1 * z
    sd["coords"] = hdl64e_angles(*cfg["resolution"], device=device)
    return sd
