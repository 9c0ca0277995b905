"""Random weights from the run's seed, made on the card in one draw.

The parameter names and shapes are the reference network's (the published
``state_dict`` names, which the program loads as they are), from the
configuration's architecture module (``architectures/``). One standard
normal vector of all the parameters is drawn from a generator on ``device``
seeded with ``seed``, and each leaf is cut from it and scaled so that the
activations keep their size through the depth: a conv or dense weight by
1 / sqrt(fan-in), a norm's gain (the module's ``GAINS``) as 1 + 0.1 z, every
bias by 0.1. No leaf is zero, so every gradient flows from the first step.
The module's ``extra_state`` adds what the network carries beside its
parameters.
"""

from __future__ import annotations

import math

import torch

from . import manifest


def reference_net(cfg: dict) -> torch.nn.Module:
    """The reference network of a configuration file's ``model`` sizes."""
    return manifest.architecture(cfg).reference_net(cfg)


def make_state_dict(cfg: dict, seed: int, device) -> dict:
    arch = manifest.architecture(cfg)
    with torch.device("meta"):
        shapes = [(n, tuple(p.shape)) for n, p in arch.reference_net(cfg).named_parameters()]
    g = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, s in shapes), generator=g, device=device)
    sd, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if name.endswith(arch.GAINS):
            sd[name] = 1.0 + 0.1 * z
        elif len(shape) >= 2:
            sd[name] = z / math.sqrt(n // shape[0])
        else:
            sd[name] = 0.1 * z
    sd.update(arch.extra_state(cfg, device))
    return sd
