"""Port ops (r2dm_tpu_torch) against the goldens and the JAX package:
config, ring padding, FIR resampling, encodings, ring conv, AdaGN, LiDAR
conversions and the log-SNR schedules, in fp32 on the CPU."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2dm_tpu import config as jax_config
from r2dm_tpu.diffusion import schedules as jax_sched
from r2dm_tpu.lidar import LiDARUtility as JaxLiDAR
from r2dm_tpu.ops import encoding as jax_enc
from r2dm_tpu.ops.pad import ring_pad as jax_ring_pad
from r2dm_tpu.ops.resample import fir_resample as jax_fir_resample
from r2dm_tpu_torch import config
from r2dm_tpu_torch.diffusion import schedules
from r2dm_tpu_torch.lidar import LiDARUtility
from r2dm_tpu_torch.models.layers import AdaGN, RingConv
from r2dm_tpu_torch.ops import encoding as enc
from r2dm_tpu_torch.ops.pad import ring_pad
from r2dm_tpu_torch.ops.resample import fir_kernel, fir_resample

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
ATOL = 1e-5


def nhwc(x):
    return np.transpose(x, (0, 2, 3, 1))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_config_matches_jax_field_for_field():
    ours, ref = config.Config(), jax_config.Config()
    for section in ("data", "model", "diffusion", "training"):
        a, b = getattr(ours, section), getattr(ref, section)
        names = [f.name for f in dataclasses.fields(a)]
        assert names == [f.name for f in dataclasses.fields(b)], section
        for n in names:
            assert getattr(a, n) == getattr(b, n), (section, n)
    # a checkpoint cfg dict (lists, unknown keys) round-trips like JAX's
    d = jax_config.asdict(jax_config.Config())
    d["data"]["resolution"] = [16, 64]
    d["model"]["unknown_key"] = 1
    assert config.asdict(config.from_dict(d)) == jax_config.asdict(jax_config.from_dict(d))
    with pytest.raises(ValueError):
        config.from_dict({"diffusion": {"prediction_type": "score"}})


def test_ring_pad_matches_golden_and_jax():
    g = np.load(GOLDEN / "ops_misc.npz")
    x = nhwc(g["x"])
    got = ring_pad(t(x), 2).numpy()
    np.testing.assert_allclose(got, nhwc(g["pad_out"]), atol=0)
    np.testing.assert_allclose(got, np.asarray(jax_ring_pad(jnp.asarray(x), 2)), atol=0)
    np.testing.assert_allclose(
        ring_pad(t(x), (1, 2, 3, 0), ring=False).numpy(),
        np.asarray(jax_ring_pad(jnp.asarray(x), (1, 2, 3, 0), ring=False)), atol=0,
    )


RESAMPLE_CASES = [
    ("down2", dict(down=2, ring=True)),
    ("up2", dict(up=2, ring=True)),
    ("down2_noring", dict(down=2, ring=False)),
    ("up2_noring", dict(up=2, ring=False)),
    ("up2_h", dict(up=2, ring=True, direction="h")),
    ("down2_w", dict(down=2, ring=True, direction="w")),
    ("up4", dict(up=4, ring=True)),
    ("down4", dict(down=4, ring=True)),
]


@pytest.mark.parametrize("name,kwargs", RESAMPLE_CASES)
def test_fir_resample_matches_golden_and_jax(name, kwargs):
    g = np.load(GOLDEN / "resample.npz")
    x = nhwc(g["x"])
    got = fir_resample(t(x), **kwargs).numpy()
    np.testing.assert_allclose(got, nhwc(g[name]), atol=ATOL)
    kernel = fir_kernel(kwargs.get("up", 1), direction=kwargs.get("direction", "hw"))
    np.testing.assert_array_equal(fir_resample(t(x), kernel=kernel, **kwargs).numpy(), got)
    np.testing.assert_allclose(got, np.asarray(jax_fir_resample(jnp.asarray(x), **kwargs)), atol=ATOL)


def test_encodings_match_golden_and_jax():
    g = np.load(GOLDEN / "encodings.npz")
    coords = np.transpose(g["coords"][0], (1, 2, 0))
    np.testing.assert_allclose(enc.generate_polar_coords(16, 64), coords, atol=ATOL)
    np.testing.assert_allclose(
        enc.get_hdl64e_linear_ray_angles(16, 64), np.transpose(g["hdl64e"][0], (1, 2, 0)), atol=ATOL
    )
    sh = enc.spherical_harmonics(t(coords), levels=5).numpy()
    np.testing.assert_allclose(sh, np.transpose(g["sh_out"][0], (1, 2, 0)), atol=ATOL)
    np.testing.assert_allclose(sh, np.asarray(jax_enc.spherical_harmonics(jnp.asarray(coords))), atol=ATOL)
    freqs = enc.fourier_feature_frequencies((16, 64))
    np.testing.assert_array_equal(freqs, g["ff_freqs"][:, :, 0, 0])
    ff = enc.fourier_features(t(coords), t(freqs)).numpy()
    np.testing.assert_allclose(ff, np.transpose(g["ff_out"][0], (1, 2, 0)), atol=1e-4)
    np.testing.assert_allclose(
        ff, np.asarray(jax_enc.fourier_features(jnp.asarray(coords), jnp.asarray(freqs))), atol=ATOL
    )
    assert enc.fourier_features_channels((64, 1024)) == 32
    assert enc.fourier_features(
        t(enc.get_hdl64e_linear_ray_angles(64, 1024)), t(enc.fourier_feature_frequencies((64, 1024)))
    ).shape == (64, 1024, 32)


def test_timestep_embedding_matches_golden_and_jax():
    g = np.load(GOLDEN / "ops_misc.npz")
    got = enc.timestep_embedding(t(g["t"]), 16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), g["spe_out"], atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_enc.timestep_embedding(jnp.asarray(g["t"]), 16)), atol=ATOL
    )


def test_ring_conv_and_adagn_match_golden():
    g = np.load(GOLDEN / "ops_misc.npz")
    x = t(nhwc(g["x"]))
    conv = RingConv(6, 10)
    conv.load_state_dict({"weight": t(g["conv_w"]), "bias": t(g["conv_b"])})
    with torch.no_grad():
        np.testing.assert_allclose(conv(x).numpy(), nhwc(g["conv_out"]), atol=ATOL)
    ada = AdaGN(num_groups=3, num_channels=6, emb_channels=12, eps=1e-5)
    ada.load_state_dict({"proj.1.weight": t(g["adagn_w"]), "proj.1.bias": t(g["adagn_b"])})
    with torch.no_grad():
        got = ada(x, t(g["emb"])).numpy()
    np.testing.assert_allclose(got, nhwc(g["adagn_out"]), atol=ATOL)


@pytest.mark.parametrize("fmt", ["log_depth", "inverse_depth", "depth"])
def test_lidar_matches_golden_and_jax(fmt):
    g = np.load(GOLDEN / "lidar.npz")
    util = LiDARUtility((16, 64), fmt, 1.45, 80.0, data_format="NCHW")
    ref = JaxLiDAR((16, 64), fmt, 1.45, 80.0, data_format="NCHW")
    metric = t(g["metric"])
    converted = util.convert_depth(metric)
    np.testing.assert_allclose(converted.numpy(), g[f"{fmt}_converted"], rtol=1e-5, atol=1e-6)
    reverted = util.revert_depth(converted)
    np.testing.assert_allclose(reverted.numpy(), g[f"{fmt}_reverted"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        reverted.numpy(), np.asarray(ref.revert_depth(ref.convert_depth(jnp.asarray(g["metric"])))),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(util.get_mask(metric).numpy(), g["mask"])
    np.testing.assert_allclose(util.to_xyz(metric).numpy(), g["xyz"], rtol=1e-4, atol=1e-4)
    nhwc_util = LiDARUtility((16, 64), fmt, 1.45, 80.0, ray_angles=g["ray_angles"], data_format="NHWC")
    np.testing.assert_allclose(
        nhwc_util.to_xyz(metric.permute(0, 2, 3, 1)).permute(0, 3, 1, 2).numpy(), g["xyz"],
        rtol=1e-4, atol=1e-4,
    )


def test_schedules_match_golden_and_jax():
    g = np.load(GOLDEN / "schedules.npz")
    ts = t(g["t"])
    for name, fn, jfn in [
        ("logsnr_linear", schedules.logsnr_linear, jax_sched.logsnr_linear),
        ("logsnr_cosine", schedules.logsnr_cosine, jax_sched.logsnr_cosine),
    ]:
        got = fn(ts).numpy()
        np.testing.assert_allclose(got, g[name], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(g["t"]))), rtol=1e-5, atol=1e-4)
    alpha, sigma = schedules.logsnr_to_alpha_sigma(t(g["logsnr_cosine"]))
    np.testing.assert_allclose(alpha.numpy(), g["alpha"], atol=ATOL)
    np.testing.assert_allclose(sigma.numpy(), g["sigma"], atol=ATOL)
