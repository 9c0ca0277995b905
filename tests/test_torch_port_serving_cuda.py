"""Card-only tests of the serving paths: every sampler mode of every family,
and RePaint, run through both CUDA kernels (exact launch counts) on a tiny
config-H-shaped net in bf16.

They skip without a CUDA device. This file imports no JAX, so on a machine
with the card and without JAX it runs as
``python -m pytest --noconftest -m cuda tests/test_torch_port_serving_cuda.py``.
"""

import dataclasses

import pytest
import torch

from r2dm_tpu_torch import config as config_lib
from r2dm_tpu_torch import ops
from r2dm_tpu_torch.inference import DDPM, build_diffusion, build_model

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# per forward of the tiny net: 8 ResidualBlocks (2 norms, 2 convs each) and
# 2 attention norms
PER_FORWARD = {"fused_group_norm_silu": 18, "fused_act_ringconv": 16, "ring_conv_w8a8": 0, "act_absmax": 0,
               "act_quantize": 0, "act_ringconv_halo": 0, "gn_stats": 0, "gn_apply": 0,
               "act_quantize_halo": 0}


def _ddpm(timestep_type: str) -> DDPM:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    cfg = config_lib.Config(
        data=config_lib.DataConfig(resolution=(16, 64)),
        model=config_lib.ModelConfig(base_channels=16, gn_num_groups=4, attn_num_heads=4,
                                     num_residual_blocks=(1, 1, 1, 1)),
        diffusion=config_lib.DiffusionConfig(timestep_type=timestep_type),
    )
    model = build_model(cfg, dtype=torch.bfloat16, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return DDPM(build_diffusion(cfg, model.to("cuda")), cfg)


def _launched(fn):
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {f.__name__: f.launches for f in ops.KERNEL_WRAPPERS}


@pytest.mark.parametrize("family,mode,forwards_per_step", [
    ("continuous", "ddpm", 1), ("continuous", "ddim", 1), ("continuous", "dpmpp_2m", 1),
    ("discrete", "ddpm", 1), ("discrete", "ddim", 1), ("flow", "euler", 1), ("flow", "midpoint", 2),
])
def test_every_sampler_runs_the_kernels(family, mode, forwards_per_step):
    ddpm = _ddpm(family)
    xs, launched = _launched(lambda: ddpm.sample(2, 3, seeds=[0, 1], mode=mode, return_all=True))
    assert launched == {k: v * 3 * forwards_per_step for k, v in PER_FORWARD.items()}
    assert xs.shape == (4, 2, 2, 16, 64) and xs.is_cuda and bool(torch.isfinite(xs).all())
    if family != "flow":  # the Gaussian samplers clip x_0
        assert xs[-1].abs().max().item() <= 1.02
    again = ddpm.sample(2, 3, seeds=[0, 1], mode=mode, progress=True, progress_chunk=2)
    assert torch.equal(again, xs[-1])


@pytest.mark.parametrize("family", ["continuous", "flow"])
def test_repaint_on_the_card_keeps_the_known_pixels(family):
    ddpm = _ddpm(family)
    known = torch.rand((2, 2, 16, 64), device="cuda") * 2 - 1
    mask = torch.zeros((2, 2, 16, 64), device="cuda")
    mask[:, :, ::4] = 1.0
    out, launched = _launched(lambda: ddpm.repaint(known, mask, 3, 2, 2, seeds=[0, 1]))
    # (T - 1) x r reverse passes and the final one, j sub-steps each
    assert launched == {k: v * 5 * 2 for k, v in PER_FORWARD.items()}
    assert bool(torch.isfinite(out).all())
    assert ((out - known).abs() * mask).max().item() <= 1e-2


def test_the_families_share_the_network():
    ddpm = _ddpm("continuous")
    cfg = dataclasses.replace(ddpm.cfg, diffusion=dataclasses.replace(ddpm.cfg.diffusion, timestep_type="flow"))
    flow = DDPM(build_diffusion(cfg, ddpm.model), cfg)
    assert flow.model is ddpm.model and flow.device.type == "cuda"
    with pytest.raises(ValueError, match="dpmpp_2m"):
        flow.sample(1, 1, mode="dpmpp_2m")
