"""The yardstick's frozen copies against the port as it stands: the FLOP
counts of both networks (each architecture module's ``flops``), the roofline arithmetic of ``chip_smoke.py``, the
synthetic scans, the trainer's step seeds, and the plain references (the
networks on the reference ``state_dict`` names, the sampler's steps, the
range-image conversions, the loss) against the port's plain CPU path."""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

from benchmark import data, manifest, weights
from benchmark.reference import diffusion as ref_diff
from benchmark.reference import lidar as ref_lidar
from benchmark.roofline import PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_FP32_FLOPS, flops, kernels
from benchmark.drivers.common import program_config, ray_angles, rel_l2
from benchmark.drivers.train import step_seed

torch.set_num_threads(1)
M = manifest.load()
H_CFG = manifest.config(M, "r2dm-h")
RN_CFG = manifest.config(M, "lidargen-refinenet")
UNET, REFINENET = (manifest.architecture(c).TINY for c in (H_CFG, RN_CFG))


def _tiny(cfg, cut):
    return json.loads(json.dumps(dict(cfg, **cut)))


def _port_model(cfg):
    from r2dm_tpu_torch.inference import build_model

    return build_model(program_config(cfg), device="cpu")


@pytest.mark.parametrize("cut", [None, UNET])
def test_unet_flops_match_the_port(cut):
    from r2dm_tpu_torch.bench import forward_flops

    cfg = H_CFG if cut is None else _tiny(H_CFG, cut)
    count = manifest.architecture(cfg).flops
    assert count(cfg) == forward_flops(_port_model(cfg))
    if cut is None:  # 229.0 GFLOP of convs and resampling, 234.9 in all
        assert sum(count(cfg)[k] for k in ("conv", "resample")) == 228_958_666_752
        assert flops.forward_flops(cfg) == 234_868_932_608


def test_refinenet_flops_match_the_port():
    cfg = _tiny(RN_CFG, REFINENET)
    net = _port_model(cfg)
    counted = []
    hooks = [m.register_forward_hook(lambda m, a, y: counted.append(2 * y[0, 0].numel() * m.weight.numel()))
             for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        net(torch.zeros(1, *cfg["resolution"], 2), torch.zeros(1))
    for h in hooks:
        h.remove()
    assert flops.forward_flops(cfg) == sum(counted)
    assert flops.forward_flops(RN_CFG) == 1_266_310_709_248


def test_roofline_arithmetic_matches_chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(manifest.ROOT))
    import chip_smoke as cs

    assert (PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_BYTES) == (cs.PEAK_BF16_FLOPS, cs.PEAK_FP32_FLOPS, cs.PEAK_BYTES)
    B = cs.B
    for C, F, H, W in cs.CONV_SHAPES:  # chip_smoke.py phase_time's flops and nbytes
        ops, nbytes = kernels.ringconv(B, H, W, C, F)
        assert ops == 2 * 9 * C * F * B * H * W
        assert nbytes == (B * H * W * (C + F)) * 2 + 9 * C * F * 2 + F * 4
    for C, H, W in cs.GN_SHAPES:  # its gn_silu_bound
        n = B * C * H * W
        assert kernels.least_seconds(*kernels.group_norm(n), PEAK_FP32_FLOPS) == max(
            2 * n * 2 / cs.PEAK_BYTES, 10 * n / cs.PEAK_FP32_FLOPS)
    sys.modules.pop("chip_smoke", None)


@pytest.mark.parametrize("seed", [0, 2**35 + 11])
def test_synthetic_scans_match_the_port(monkeypatch, seed):
    """Bit for bit against the port's generator through its plain numpy
    projection (its C++ core fills one more pixel of seed 0's first scan)."""
    import r2dm_tpu_torch.data.datasets as datasets
    from r2dm_tpu_torch.data.projection import project_points_numpy

    monkeypatch.setattr(datasets, "project_points", project_points_numpy)
    port = datasets.SyntheticLiDAR(num_scans=3, projection="spherical-1024", seed=seed)
    for i in range(3):
        np.testing.assert_array_equal(data.scan(seed, i), port.planes(i))


def test_step_seed_matches_the_trainer():
    from r2dm_tpu_torch.train import step_generator

    for seed, step in ((5, 0), (2**40 + 1, 10_003)):
        ours = torch.Generator().manual_seed(step_seed(seed, step))
        assert torch.equal(torch.rand(5, generator=ours), torch.rand(5, generator=step_generator(seed, step, "cpu")))


@pytest.mark.parametrize("cfg", [H_CFG, RN_CFG], ids=["r2dm-h", "lidargen-refinenet"])
def test_reference_names_and_shapes_are_the_port_s(cfg):
    with torch.device("meta"):
        ours = {n: tuple(p.shape) for n, p in weights.reference_net(cfg).named_parameters()}
    port = {n: tuple(p.shape) for n, p in _port_model(cfg).named_parameters()}
    assert ours == port


@pytest.mark.parametrize("cfg,cut", [(H_CFG, UNET), (RN_CFG, REFINENET)], ids=["r2dm-h", "lidargen-refinenet"])
def test_reference_network_matches_the_port(cfg, cut):
    cfg = _tiny(cfg, cut)
    sd = weights.make_state_dict(cfg, 1234, "cpu")
    port = _port_model(cfg)
    port.load_state_dict(sd)
    ref = weights.reference_net(cfg)
    ref.load_state_dict(sd)
    x = torch.randn(3, *cfg["resolution"], 2, generator=torch.Generator().manual_seed(1))
    cond = torch.tensor([-12.0, 0.5, 9.0])
    with torch.no_grad():
        assert rel_l2(port.eval()(x, cond), ref.eval()(x, cond)) < 1e-5


def test_reference_steps_match_the_port():
    from r2dm_tpu_torch.diffusion import ContinuousTimeGaussianDiffusion
    from r2dm_tpu_torch.diffusion.schedules import logsnr_cosine

    t = torch.linspace(0, 1, 33)
    torch.testing.assert_close(ref_diff.logsnr(t), logsnr_cosine(t), rtol=1e-6, atol=1e-5)
    g = torch.Generator().manual_seed(3)
    x, eps, z = (torch.randn(2, 4, 8, 2, generator=g) for _ in range(3))

    class Fixed(torch.nn.Module):
        in_channels, resolution = 2, (4, 8)

        def __init__(self):
            super().__init__()
            self.p = torch.nn.Parameter(torch.zeros(1))

        def forward(self, x_t, cond):
            return eps

    diff = ContinuousTimeGaussianDiffusion(Fixed())
    for t, s in ((1.0, 0.75), (0.5, 0.25), (0.125, 0.0)):
        torch.testing.assert_close(ref_diff.ddpm_step(x, eps, t, s, z), diff.p_step(x, t, s, noise=z, mode="ddpm"),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ref_diff.ddim_step(x, eps, t, s), diff.p_step(x, t, s, mode="ddim"),
                                   rtol=1e-5, atol=1e-5)
    steps = torch.tensor([0.1, 0.9])
    ours = ref_diff.per_sample_loss(lambda x_t, c: eps, x, steps, z).mean()
    torch.testing.assert_close(ours, diff.p_loss(lambda x_t, c, **k: eps, x, steps, z), rtol=1e-5, atol=1e-6)


def test_reference_conversions_match_the_port():
    from r2dm_tpu_torch.data import preprocess_batch
    from r2dm_tpu_torch.lidar import LiDARUtility
    from r2dm_tpu_torch.sample_and_save import postprocess

    planes = torch.from_numpy(np.stack([data.scan(9, i, 16, 64) for i in range(2)]))
    angles = ray_angles({"resolution": [16, 64]}, "cpu")
    lu = LiDARUtility((16, 64), "log_depth", 1.45, 80.0, ray_angles=angles, data_format="NHWC")
    got = preprocess_batch(lu, {"depth": planes[..., 4:5], "reflectance": planes[..., 3:4]}, (16, 64))
    torch.testing.assert_close(ref_lidar.preprocess(planes[..., 4:5], planes[..., 3:4]), got)
    x = torch.rand(2, 2, 16, 64, generator=torch.Generator().manual_seed(4)) * 2.2 - 1.1
    lu.data_format = "NCHW"
    torch.testing.assert_close(ref_lidar.postprocess(x, angles), postprocess(x, lu), rtol=1e-5, atol=1e-5)
