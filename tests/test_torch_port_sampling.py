"""The whole sampling slice: one tiny checkpoint loaded by the JAX package's
and the port's setup_model, the same x_T (and injected noise) through both
samplers, and the LiDAR conversion of the result, on the CPU."""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2dm_tpu import Config as JaxConfig
from r2dm_tpu import setup_model as jax_setup_model
from r2dm_tpu.config import DataConfig, ModelConfig, asdict
from r2dm_tpu.inference import build_model as jax_build_model
from r2dm_tpu.inference import model_coords as jax_model_coords
from r2dm_tpu.utils.torch_import import export_unet_state_dict
from r2dm_tpu_torch import pretrained_r2dm, setup_model
from r2dm_tpu_torch.inference import model_coords

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"


def tiny_cfg() -> JaxConfig:
    return JaxConfig(
        data=DataConfig(resolution=(16, 64)),
        model=ModelConfig(
            base_channels=16, gn_num_groups=4, attn_num_heads=4, num_residual_blocks=(1, 1, 1, 1),
        ),
    )


@pytest.fixture(scope="module")
def ckpt():
    """A reference-layout checkpoint dict of a random tiny config-H-shaped
    net with a non-zero out_conv."""
    cfg = tiny_cfg()
    model = jax_build_model(cfg)
    params = model.init(jax.random.key(0), jnp.zeros((1, 16, 64, 2)), jnp.zeros((1,)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda l: rng.standard_normal(l.shape).astype(np.float32) * 0.05, params)
    variables = {"params": params, "buffers": {"coords": jax_model_coords(cfg)}}
    return {"cfg": asdict(cfg), "weights": export_unet_state_dict(variables), "global_step": 1}


@pytest.fixture(scope="module")
def both(ckpt):
    return jax_setup_model(ckpt, ema=False), setup_model(ckpt, ema=False, device="cpu")


def test_ddim_chain_matches_jax(both):
    (jddpm, _, _), (ddpm, _, _) = both
    x_T = np.random.default_rng(1).standard_normal((2, 16, 64, 2)).astype(np.float32)
    ts = jnp.linspace(1.0, 0.0, 5, dtype=jnp.float32)
    ref, _ = jax.jit(jddpm.diffusion.sample_segment, static_argnames=("mode",))(
        jddpm.variables, jnp.asarray(x_T), jax.random.key(0), ts, mode="ddim"
    )
    got = ddpm.sample(2, 4, mode="ddim", x_T=torch.from_numpy(x_T), data_format="NHWC")
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    # the networks agree to ~1e-6 relative; the first step divides by
    # alpha(t=1) = 5.5e-4, so the few pixels whose x_0 estimate falls inside
    # the clip range carry that difference up to ~1.2e-4 at |x| ~ 1: rtol
    # 1e-4 on top of atol 1e-4 (ROADMAP.md queue 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    assert float(np.median(np.abs(got.numpy() - np.asarray(ref)))) <= 1e-6
    nchw = ddpm.sample(2, 4, mode="ddim", x_T=torch.from_numpy(x_T))
    assert nchw.shape == (2, 2, 16, 64)
    np.testing.assert_array_equal(nchw.numpy(), np.transpose(got.numpy(), (0, 3, 1, 2)))


def test_ddpm_steps_with_injected_noise_match_jax(both):
    (jddpm, _, _), (ddpm, _, _) = both
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 64, 2)).astype(np.float32)
    noise = rng.standard_normal((2, 2, 16, 64, 2)).astype(np.float32)
    ts = np.linspace(1.0, 0.0, 3).astype(np.float32)
    p_step = jax.jit(jddpm.diffusion.p_step, static_argnames=("mode",))
    ref = jnp.asarray(x)
    for i in range(2):
        ref = p_step(jddpm.variables, ref, ts[i], ts[i + 1], noise=jnp.asarray(noise[i]), mode="ddpm")
    got = ddpm.sample(
        2, 2, mode="ddpm", x_T=torch.from_numpy(x), noise=torch.from_numpy(noise), data_format="NHWC"
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    steps = np.array([0.3, 0.8], np.float32)
    q_ref = jddpm.diffusion.q_step_from_x_0(jnp.asarray(x), jnp.asarray(steps), jnp.asarray(noise[0]))
    q = ddpm.diffusion.q_step_from_x_0(torch.from_numpy(x), torch.from_numpy(steps), torch.from_numpy(noise[0]))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), atol=1e-5)


def test_samples_to_points_match_jax_and_golden(both):
    (jddpm, jlidar, _), (ddpm, lidar, cfg) = both
    x = ddpm.sample(2, 2, mode="ddim", seeds=[3, 4])
    assert x.shape == (2, 2, 16, 64) and bool(torch.isfinite(x).all())
    depth = lidar.revert_depth(lidar.denormalize(x[:, [0]]))
    xyz = lidar.to_xyz(depth)
    ref = jlidar.to_xyz(jlidar.revert_depth(jlidar.denormalize(jnp.asarray(x[:, [0]].numpy()))))
    np.testing.assert_allclose(xyz.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        lidar.ray_angles.numpy(), np.asarray(jlidar.ray_angles), atol=1e-6
    )
    g = np.load(GOLDEN / "lidar.npz")
    np.testing.assert_allclose(
        lidar.to_xyz(torch.from_numpy(g["metric"])).numpy(), g["xyz"], rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(model_coords(cfg), jax_model_coords(tiny_cfg()), atol=0)


def test_seeded_samples_do_not_depend_on_chunking(both):
    _, (ddpm, _, _) = both
    a = ddpm.sample(3, 2, seeds=[7, 8, 9])
    b = ddpm.sample(3, 2, seeds=[7, 8, 9], batch_chunk=1)
    c = ddpm.sample(1, 2, seeds=[8])
    # same draws per row; the CPU conv picks batch-size-dependent algorithms,
    # so the values agree to fp32 rounding amplified by the t=1 step
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3)
    np.testing.assert_allclose(a[1:2].numpy(), c.numpy(), atol=2e-3)
    other = ddpm.sample(1, 2, seeds=[10])
    assert float((other - c).abs().max()) > 0.1
    d = ddpm.sample(1, 2)
    e = ddpm.sample(1, 2)
    assert float((d - e).abs().max()) > 1e-3  # fresh draws without seeds


def test_checkpoint_files_and_pretrained_lookup(ckpt, tmp_path, monkeypatch):
    monkeypatch.delenv("R2DM_CKPT_DIR", raising=False)
    # an empty cache, and a fetch that fails with no network traffic
    monkeypatch.setenv("R2DM_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("R2DM_WEIGHTS_URL_BASE", (tmp_path / "no-release").as_uri())
    with pytest.raises(FileNotFoundError):
        pretrained_r2dm("r2dm-h-kitti360-300k", device="cpu")
    ema = {f"ema_model.{k}": torch.from_numpy(v) for k, v in ckpt["weights"].items()}
    ema.update({"initted": torch.tensor(True), "step": torch.tensor(3)})
    path = tmp_path / "r2dm-h-kitti360-300k.pth"
    torch.save({**ckpt, "ema_weights": ema}, path)
    monkeypatch.setenv("R2DM_CKPT_DIR", str(tmp_path))
    ddpm, lidar, cfg = pretrained_r2dm("r2dm-h-kitti360-300k", device="cpu")
    assert cfg.data.resolution == (16, 64) and ddpm.sampling_shape == (16, 64, 2)
    ref, _, _ = setup_model(ckpt, ema=False, device="cpu")
    for (k, v), (_, w) in zip(ddpm.model.state_dict().items(), ref.model.state_dict().items()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    with pytest.raises(ValueError):
        setup_model(ckpt, device="cuda")  # a CUDA model computes in bf16
    assert os.environ["R2DM_CKPT_DIR"] == str(tmp_path)
