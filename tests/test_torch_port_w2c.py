"""The W2C latency layout (``width_merge_l1``) in the port, on the CPU: the
port's network with the flag against the JAX package's width-pair-merged
network on shared weights (tests/test_w2c.py:229), ``setup_model`` with the
flag equal to without it, a RefineNet refusing it, and the trainer handing
``training.width_merge_l1`` to ``build_model``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2dm_tpu.models.efficient_unet import EfficientUNet as JaxUNet
from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch import train
from r2dm_tpu_torch.inference import build_model, model_coords, setup_model
from r2dm_tpu_torch.models.efficient_unet import EfficientUNet
from r2dm_tpu_torch.utils.weights import state_dict_from_jax

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

# tests/test_w2c.py:207-216's network
KWARGS = dict(in_channels=2, resolution=(16, 64), base_channels=8, channel_multiplier=(1, 2, 2, 2),
              num_residual_blocks=(2, 1, 1, 1), gn_num_groups=4, attn_num_heads=2)


@pytest.mark.parametrize("coords", [None, "fourier_features"])
def test_w2c_network_matches_jax_width_merged_network(coords):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 16, 64, 2)).astype(np.float32)
    cond = np.array([0.3, 2.1], np.float32)
    jnet = JaxUNet(width_merge_l1=True, coords_encoding=coords, **KWARGS)
    variables = jax.jit(jnet.init)(jax.random.key(14), jnp.zeros((1, 16, 64, 2)), jnp.zeros((1,)))
    prng = np.random.default_rng(15)
    variables = {"params": jax.tree.map(lambda l: prng.standard_normal(l.shape).astype(np.float32) * 0.1,
                                        variables["params"]),
                 "buffers": {"coords": np.asarray(variables["buffers"]["coords"])}}
    want = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x), jnp.asarray(cond)))
    net = EfficientUNet(width_merge_l1=True, coords_encoding=coords, **KWARGS)
    assert net.width_merge_l1
    net.load_state_dict(state_dict_from_jax(variables))  # the merged net's tree is the NHWC one's
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=2e-4)


def _cfg(architecture="efficient_unet"):
    return port_config.Config(
        data=port_config.DataConfig(dataset="synthetic", resolution=(16, 64), projection="spherical-256"),
        model=port_config.ModelConfig(architecture=architecture, base_channels=8, channel_multiplier=(1, 2, 2, 2),
                                      num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2),
    )


def test_setup_model_with_the_flag_equals_without_and_refinenet_refuses(tmp_path):
    cfg = _cfg()
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        model.coords.copy_(torch.from_numpy(model_coords(cfg).transpose(2, 0, 1)[None].copy()))
    path = tmp_path / "tiny.pth"
    torch.save({"cfg": port_config.asdict(cfg), "weights": {f"model.{k}": v for k, v in model.state_dict().items()}},
               path)
    (a, _, _), (b, _, _) = (setup_model(str(path), device="cpu", width_merge_l1=f) for f in (False, True))
    assert b.model.width_merge_l1 and not a.model.width_merge_l1
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, 64, 2)).astype(np.float32))
    with torch.no_grad():
        ya, yb = a.model(x, torch.tensor([0.5, -0.5])), b.model(x, torch.tensor([0.5, -0.5]))
    assert float(ya.abs().max()) > 1e-3
    assert torch.equal(ya, yb)
    assert torch.equal(a.sample(2, 2, seeds=[0, 1]), b.sample(2, 2, seeds=[0, 1]))
    with pytest.raises(ValueError, match="EfficientUNet-only"):
        build_model(_cfg("refinenet"), device="cpu", width_merge_l1=True)
    assert not build_model(_cfg("refinenet"), device="cpu").training


@pytest.mark.parametrize("architecture", ["efficient_unet", "refinenet"])
def test_trainer_hands_width_merge_l1_to_build_model(architecture, tmp_path, monkeypatch):
    """training.width_merge_l1 (default True, as in JAX) reaches an
    EfficientUNet; a RefineNet is built without it, as the JAX trainer does
    (train.py:215-216)."""
    seen, real = [], train.build_model

    def recording(cfg, **kw):
        seen.append(kw.get("width_merge_l1"))
        return real(cfg, **kw)

    monkeypatch.setattr(train, "build_model", recording)
    monkeypatch.setenv("R2DM_SYNTH_SCANS", "4")
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)
    argv = ["--device", "cpu", "--data.dataset", "synthetic", "--data.projection", "spherical-256",
            "--data.resolution", "16,64", "--model.architecture", architecture, "--model.base_channels", "8",
            "--model.channel_multiplier", "1,2,2,2", "--model.num_residual_blocks", "1,1,1,1",
            "--model.gn_num_groups", "4", "--model.attn_num_heads", "2", "--training.batch_size_train", "2",
            "--training.num_steps", "1", "--training.mixed_precision", "no",
            "--training.output_dir", str(tmp_path / "run")]
    train.main(argv)
    assert seen == [architecture == "efficient_unet"]
