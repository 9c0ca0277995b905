"""LiDARGen's RefineNet: what the harness needs of the architecture.

Found by ``manifest.architecture`` from a configuration file whose
``architecture`` is ``refinenet``. The reference network is
``reference/refinenet.py``'s; the port's is ``r2dm_tpu_torch.models.refinenet``,
built by ``build_model`` from the fields ``program_model`` sets.
"""

from __future__ import annotations

import torch

from benchmark.drivers.common import ray_angles
from benchmark.reference.refinenet import RefineNet

# the CPU tests' cut: a few channels at 16 x 64
TINY = {"resolution": [16, 64], "base_channels": 8}
# parameter names of the InstanceNorm++ gains, drawn as 1 + 0.1 z
GAINS = ("alpha", "post_affine.weight")
# the control of each driver: the port's RefineNet has no int8 lane, so the
# reference in fp8 takes the program's place
CONTROLS = {"chain": "fp8", "closed_loop": "fp8", "train": "fp8"}


def reference_net(cfg: dict) -> torch.nn.Module:
    return RefineNet(in_channels=cfg["in_channels"], resolution=tuple(cfg["resolution"]),
                     base_channels=cfg["base_channels"], channel_multiplier=tuple(cfg["channel_multiplier"]))


def extra_state(cfg: dict, device) -> dict:
    """The state beyond the parameters: ``coords``, the HDL-64E grid of ray
    angles the trainer sets in the network's buffer."""
    return {"coords": ray_angles(cfg, device)}


def program_model(cfg: dict, m) -> None:
    """The port's ``Config.model`` fields of the configuration file."""
    m.architecture, m.base_channels = "refinenet", cfg["base_channels"]
    m.channel_multiplier = tuple(cfg["channel_multiplier"])


def program_net():
    """The port's network class, whose forward the correctness check's
    faults patch."""
    from r2dm_tpu_torch.models.refinenet import LiDARGenRefineNet

    return LiDARGenRefineNet


def flops(cfg: dict) -> dict:
    """Operations of one forward of one image (a multiply-add counts 2):
    every convolution, each at its output's resolution, walked on the meta
    device, so no memory is touched and no weight is needed."""
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


def wrapped_work() -> list:
    """No call of the RefineNet is attributed: it runs no hand-written kernel."""
    return []


def wrapped_probes() -> dict:
    return {}
