"""The port's reflow (``python -m r2dm_tpu_torch.reflow``) against the JAX
tool ``tools/reflow.py`` on the CPU, in fp32 at a tiny size: the teacher
pairs from the same eps, reflow steps from the same minibatches and times,
and the CLI end to end, its checkpoint read by both packages.

Tolerances: fp32 rtol 1e-4, atol 2e-5 (tests/test_unet_parity.py:50); the
pairs are stored in bfloat16, so they are held to one bf16 step (2^-8 of the
value) where the fp32 ODEs agree to rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from r2dm_tpu.diffusion.flow import RectifiedFlow as JaxFlow
from r2dm_tpu.inference import setup_model as jax_setup_model
from r2dm_tpu.models.efficient_unet import EfficientUNet as JaxUNet
from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch import reflow, setup_model
from r2dm_tpu_torch.checkpoint import load_checkpoint, write_checkpoint
from r2dm_tpu_torch.diffusion.flow import RectifiedFlow
from r2dm_tpu_torch.inference import build_model, model_coords
from r2dm_tpu_torch.models.efficient_unet import EfficientUNet
from r2dm_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

TINY = dict(in_channels=2, resolution=(16, 64), base_channels=8, channel_multiplier=(1, 2, 2, 2),
            num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2, coords_encoding=None)
RTOL, ATOL = 1e-4, 2e-5
LR = 1e-3


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def tiny_flow():
    """The tiny JAX network with weights ~ N(0, 0.05^2) from numpy, and the
    port's copy of it inside a RectifiedFlow."""
    net = JaxUNet(**TINY)
    variables = jax.jit(net.init)(jax.random.key(0), jnp.zeros((1, 16, 64, 2)), jnp.zeros((1,)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda l: (rng.standard_normal(l.shape) * 0.05).astype(np.float32), variables["params"])
    variables = {"params": params, "buffers": jax.tree.map(np.asarray, variables["buffers"])}
    model = EfficientUNet(**TINY)
    model.load_state_dict(state_dict_from_jax(variables))
    return JaxFlow(model=net), variables, RectifiedFlow(model.eval())


def test_teacher_pairs_match_jax_sample_segment(tiny_flow):
    jflow, variables, flow = tiny_flow
    eps = np.random.default_rng(2).standard_normal((3, 16, 64, 2)).astype(np.float32)
    ts = jnp.linspace(1.0, 0.0, 4 + 1, dtype=jnp.float32)
    ref, _ = jax.jit(lambda e: jflow.sample_segment(variables, e, jax.random.key(0), ts))(jnp.asarray(eps))
    e16, x16 = reflow.teacher_pairs(flow, t(eps), 4)
    assert e16.dtype == x16.dtype == torch.bfloat16 and not x16.is_inference() and tuple(x16.shape) == eps.shape
    assert torch.equal(e16, t(eps).bfloat16())
    ref = np.asarray(ref)
    np.testing.assert_allclose(x16.float().numpy(), ref, rtol=2.0 ** -8, atol=ATOL)
    # and the fp32 ODE itself to rtol 1e-4, before the pair is stored in bf16
    with torch.no_grad():
        x32 = flow.sample_segment(t(eps), torch.linspace(1.0, 0.0, 5))
    np.testing.assert_allclose(x32.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_reflow_steps_match_jax(tiny_flow):
    """Two steps of tools/reflow.py's reflow_step (AdamW(lr, 0.9, 0.99, wd
    0), p_loss with the paired noise) from the same pairs, minibatch
    indices and times, against reflow.reflow_step: the loss and every
    parameter (lr-scaled atol, as the trainer's steps)."""
    jflow, variables, _ = tiny_flow
    model = EfficientUNet(**TINY)
    model.load_state_dict(state_dict_from_jax(variables))
    flow = RectifiedFlow(model.eval())
    rng = np.random.default_rng(3)
    x_data = rng.uniform(-1, 1, (6, 16, 64, 2)).astype(np.float32)
    eps_data = rng.standard_normal((6, 16, 64, 2)).astype(np.float32)
    x16, e16 = t(x_data).bfloat16(), t(eps_data).bfloat16()  # the pairs as both tools store them

    tx = optax.adamw(LR, b1=0.9, b2=0.99, weight_decay=0.0)
    params, buffers = variables["params"], variables["buffers"]
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, x_pair, eps_pair, steps):
        def loss_fn(p):
            return jflow.p_loss({"params": p, "buffers": buffers}, x_pair, steps, noise=eps_pair)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    optimizer = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.0)
    for i in range(2):
        idx = rng.integers(0, 6, 4)
        steps = rng.uniform(0, 1, 4).astype(np.float32)
        x_pair = x16.float().numpy()[idx]
        eps_pair = e16.float().numpy()[idx]
        params, opt_state, jloss = jax_step(params, opt_state, x_pair, eps_pair, steps)
        loss = reflow.reflow_step(flow, optimizer, x16, e16, torch.from_numpy(idx), t(steps))
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=RTOL, atol=ATOL, err_msg=f"loss {i}")
        ref = state_dict_from_jax({"params": params})
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=RTOL, atol=1e-2 * LR,
                                       err_msg=f"{name}, step {i}")


def _flow_msgpack(path, timestep_type="flow"):
    cfg = port_config.Config(
        data=port_config.DataConfig(dataset="synthetic", resolution=(16, 64), projection="spherical-256"),
        model=port_config.ModelConfig(base_channels=8, channel_multiplier=(1, 2, 2, 2),
                                      num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2),
        diffusion=port_config.DiffusionConfig(timestep_type=timestep_type),
    )
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    model.coords.copy_(t(model_coords(cfg).transpose(2, 0, 1)[None]))
    variables = jax_from_state_dict(model.state_dict())
    return write_checkpoint(str(path), port_config.asdict(cfg), variables, ema_weights=variables, step=3)


def test_reflow_cli_writes_a_checkpoint_both_packages_load(tmp_path, capsys):
    """tools/reflow.py's flags on a tiny flow checkpoint (tests/test_flow.py
    320-340): the written file is the JAX layout with EMA = weights and the
    step = train_steps; r2dm_tpu.inference.setup_model loads it and samples
    one finite euler step, the port's setup_model too, and the two networks
    agree on it. A non-flow checkpoint exits with the JAX tool's message."""
    src = _flow_msgpack(tmp_path / "flow.msgpack")
    out = str(tmp_path / "reflowed.msgpack")
    argv = ["--ckpt", src, "--out", out, "--num_pairs", "6", "--teacher_steps", "2", "--batch_size", "4",
            "--train_steps", "3", "--seed", "0", "--device", "cpu"]
    assert reflow.main(argv) == 0
    text = capsys.readouterr().out
    assert "pairs [4/6]" in text and "pairs [6/6]" in text and "reflow step 2: loss" in text
    ck = load_checkpoint(out)
    assert ck["global_step"] == 3 and ck["opt_state"] is None
    before = load_checkpoint(src)["weights"]["params"]["in_conv"]["conv"]["kernel"]
    assert not np.array_equal(ck["weights"]["params"]["in_conv"]["conv"]["kernel"], before)
    for a, b in zip(jax.tree.leaves(ck["weights"]), jax.tree.leaves(ck["ema_weights"])):
        np.testing.assert_array_equal(a, b)

    jddpm, _, jcfg = jax_setup_model(out)
    assert isinstance(jddpm.diffusion, JaxFlow) and jcfg.diffusion.timestep_type == "flow"
    y = np.asarray(jddpm.sample(batch_size=2, num_steps=1, seeds=[0, 1], mode="euler"))
    assert y.shape == (2, 2, 16, 64) and np.isfinite(y).all()
    ddpm, _, _ = setup_model(out, device="cpu")
    assert isinstance(ddpm.diffusion, RectifiedFlow)
    x = np.random.default_rng(5).standard_normal((2, 16, 64, 2)).astype(np.float32)
    steps = np.asarray([0.3, 0.8], np.float32)
    with torch.no_grad():
        got = ddpm.model(t(x), t(steps) * 1000.0).numpy()
    ref = jax.jit(jddpm.diffusion.model.apply)(jddpm.variables, x, steps * 1000.0)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)

    with pytest.raises(SystemExit, match="reflow requires a flow checkpoint"):
        reflow.main(["--ckpt", _flow_msgpack(tmp_path / "cont.msgpack", "continuous"), "--out", out,
                     "--device", "cpu"])
