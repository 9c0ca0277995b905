"""The port's ResidualBlock and EfficientUNet against the flax modules and
the captured reference goldens, in fp32 on the CPU, with weights carried by
r2dm_tpu_torch.utils.weights.state_dict_from_jax."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2dm_tpu.models import layers as jax_layers
from r2dm_tpu.models.efficient_unet import EfficientUNet as JaxUNet
from r2dm_tpu_torch.models.efficient_unet import EfficientUNet
from r2dm_tpu_torch.models.layers import ResidualBlock
from r2dm_tpu_torch.utils.weights import DROP, state_dict_from_jax

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
TINY = dict(
    in_channels=2,
    resolution=(16, 64),
    base_channels=16,
    channel_multiplier=(1, 2, 4, 8),
    num_residual_blocks=(1, 1, 1, 1),
    gn_num_groups=4,
    attn_num_heads=4,
)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def randomize(tree, seed, std=0.1):
    """Every leaf ~ N(0, std^2) from numpy, so zero-init convs are non-zero."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda l: rng.standard_normal(l.shape).astype(np.float32) * std, tree)


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 32)])
def test_residual_block_matches_flax(cin, cout):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 32, cin), np.float32)
    emb = rng.standard_normal((2, 24), np.float32)
    blk = jax_layers.ResidualBlock(out_channels=cout, gn_num_groups=4)
    params = randomize(blk.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(emb))["params"], 1)
    ref = blk.apply({"params": params}, jnp.asarray(x), jnp.asarray(emb))

    sd = state_dict_from_jax({"params": {"d_block1": {"res0": params}}})
    prefix = "d_block1.residual_blocks.0."
    ours = ResidualBlock(cin, cout, emb_channels=24, gn_num_groups=4)
    ours.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = ours(t(x), t(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


def _golden(name):
    g = np.load(GOLDEN / f"{name}.npz")
    return g, {k[4:]: g[k] for k in g.files if k.startswith("sd::")}


@pytest.mark.parametrize("cenc", ["fourier_features", "spherical_harmonics", "polar_coordinates"])
def test_unet_matches_reference_goldens(cenc):
    g, sd = _golden(f"tiny_unet_{cenc}")
    net = EfficientUNet(coords_encoding=cenc, **TINY)
    # the captured reference keys load as they are; only the constants the
    # port recomputes (FIR kernels, scales, encoding tables) are left over
    missing, unexpected = net.load_state_dict({k: t(v) for k, v in sd.items()}, strict=False)
    assert missing == [] and unexpected and all(DROP.search(k) for k in unexpected)
    with torch.no_grad():
        y = net(t(np.transpose(g["x"], (0, 2, 3, 1))), t(g["t"]))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.transpose(g["y"], (0, 2, 3, 1)), rtol=1e-4, atol=2e-5)


def test_unet_matches_flax_random_init():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 64, 2), np.float32)
    cond = np.array([3.0, -2.0], np.float32)
    jnet = JaxUNet(coords_encoding="fourier_features", **TINY)
    variables = jnet.init(jax.random.key(0), jnp.zeros((1, 16, 64, 2)), jnp.zeros((1,)))
    variables = {
        "params": randomize(variables["params"], 6, std=0.05),
        "buffers": {"coords": np.asarray(variables["buffers"]["coords"]) * 0.9},
    }
    ref = jnet.apply(variables, jnp.asarray(x), jnp.asarray(cond))
    net = EfficientUNet(coords_encoding="fourier_features", **TINY)
    net.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        y = net(t(x), t(cond))
    assert float(np.abs(np.asarray(ref)).max()) > 1e-2  # out_conv is non-zero
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-5)


def test_unet_bf16_policy_runs_close_to_fp32():
    """dtype=bfloat16: params stay fp32, activations bf16, output fp32."""
    g, sd = _golden("tiny_unet_fourier_features")
    net32 = EfficientUNet(coords_encoding="fourier_features", **TINY)
    net16 = EfficientUNet(coords_encoding="fourier_features", dtype=torch.bfloat16, **TINY)
    state = {k: t(v) for k, v in sd.items() if not DROP.search(k)}
    net32.load_state_dict(state)
    net16.load_state_dict(state)
    assert all(p.dtype == torch.float32 for p in net16.parameters())
    x = t(np.transpose(g["x"], (0, 2, 3, 1)))
    with torch.no_grad():
        y32, y16 = net32(x, t(g["t"])), net16(x, t(g["t"]))
    assert y16.dtype == torch.float32
    rel = float((y16 - y32).norm() / y32.norm())
    assert rel < 5e-2, rel
