"""The port's training slice against the JAX package, in fp32 on the CPU: the
backward of both kernel wrappers, the loss and its gradients, AdamW + EMA
train steps, the LR and EMA schedules, dropout, and the msgpack checkpoint
writer both ways. Inputs are made with numpy from a seed and handed to both
frameworks; weights go across through ``state_dict_from_jax``.

Tolerances: fp32 rtol 1e-4, atol 2e-5 (tests/test_unet_parity.py:50) unless
a test says why it needs another.
"""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from r2dm_tpu import checkpoint as jax_checkpoint
from r2dm_tpu.config import TrainingConfig as JaxTrainingConfig
from r2dm_tpu.diffusion import ContinuousTimeGaussianDiffusion as JaxContinuous
from r2dm_tpu.diffusion.base import split_key
from r2dm_tpu.diffusion.base import normal as jax_normal
from r2dm_tpu.models import layers as jax_layers
from r2dm_tpu.models.efficient_unet import EfficientUNet as JaxUNet
from r2dm_tpu.training import EMAConfig as JaxEMAConfig
from r2dm_tpu.training import cosine_schedule_with_warmup as jax_schedule
from r2dm_tpu.training import ema_decay as jax_ema_decay
from r2dm_tpu.training import init_train_state as jax_init_train_state
from r2dm_tpu.training import make_optimizer as jax_make_optimizer
from r2dm_tpu.training import make_train_step as jax_make_train_step
from r2dm_tpu_torch import checkpoint, setup_model
from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch.diffusion import ContinuousTimeGaussianDiffusion
from r2dm_tpu_torch.inference import build_model
from r2dm_tpu_torch.models import layers
from r2dm_tpu_torch.models.efficient_unet import EfficientUNet
from r2dm_tpu_torch.ops import act_ringconv, gn_silu
from r2dm_tpu_torch.train import resume
from r2dm_tpu_torch.training import (
    EMAConfig,
    cosine_schedule_with_warmup,
    ema_decay,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from r2dm_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

# tests/test_training.py:25-34
TINY = dict(
    in_channels=2,
    resolution=(16, 64),
    base_channels=8,
    channel_multiplier=(1, 2, 2, 2),
    num_residual_blocks=(1, 1, 1, 1),
    gn_num_groups=4,
    attn_num_heads=2,
    coords_encoding=None,
)
RTOL, ATOL = 1e-4, 2e-5


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(got, ref, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol, err_msg=what)


def randomize(tree, seed, std=0.1):
    """Every leaf ~ N(0, std^2) from numpy, so zero-init convs are non-zero
    and every parameter gets a gradient."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda l: (rng.standard_normal(l.shape) * std).astype(np.float32), tree)


@pytest.fixture(scope="module")
def tiny():
    """The tiny JAX network with random weights and the port's copy of it."""
    net = JaxUNet(**TINY)
    variables = jax.jit(net.init)(jax.random.key(0), jnp.zeros((1, 16, 64, 2)), jnp.zeros((1,)))
    variables = {"params": randomize(variables["params"], 1), "buffers": jax.tree.map(np.asarray, variables["buffers"])}
    return net, variables


def port_net(variables):
    net = EfficientUNet(**TINY)
    net.load_state_dict(state_dict_from_jax(variables))
    return net


def batch(seed, B=2):
    rng = np.random.default_rng(seed)
    x_0 = rng.uniform(-1, 1, (B, 16, 64, 2)).astype(np.float32)
    steps = rng.uniform(0, 1, (B,)).astype(np.float32)
    noise = rng.standard_normal((B, 16, 64, 2)).astype(np.float32)
    return x_0, steps, noise


# --------------------------------------------------------------- (a) kernels
@pytest.mark.parametrize("per_batch", [False, True])
@pytest.mark.parametrize("silu", [True, False])
def test_gn_backward_matches_autograd_and_jax(per_batch, silu):
    rng = np.random.default_rng(3)
    B, H, W, C, G, eps = 2, 4, 8, 16, 4, 1e-6
    x = rng.standard_normal((B, H, W, C)).astype(np.float32) + 0.3
    aff = (B, C) if per_batch else (C,)
    gain = (1.0 + 0.5 * rng.standard_normal(aff)).astype(np.float32)
    shift = (0.5 * rng.standard_normal(aff)).astype(np.float32)
    dy = rng.standard_normal((B, H, W, C)).astype(np.float32)

    ours = gn_silu.gn_silu_backward(t(x), t(gain), t(shift), G, eps, silu, t(dy))

    # the autograd.Function itself (plain forward on the CPU), and autograd
    # of the plain version
    def grads(fn):
        xs = [t(v).requires_grad_() for v in (x, gain, shift)]
        fn(*xs, G, eps, silu).backward(t(dy))
        return [v.grad for v in xs]

    func = grads(gn_silu.GroupNormSiLU.apply)
    plain = grads(gn_silu.fused_group_norm_silu_plain)
    _, vjp = jax.vjp(lambda a, g, s: jax_layers._gn_act(a, G, eps, g, s, silu), x, gain, shift)
    ref = vjp(jnp.asarray(dy))
    for name, o, f, p, r in zip(("dx", "d_gain", "d_shift"), ours, func, plain, ref):
        assert o.shape == r.shape, name
        close(o, r, what=f"{name} vs jax.vjp")
        close(f, r, what=f"{name} of the autograd.Function vs jax.vjp")
        close(o, p, what=f"{name} vs autograd of the plain version")


@pytest.mark.parametrize("shape,F", [((2, 5, 12, 16), 24), ((1, 3, 8, 8), 8)])
def test_ring_conv_backward_matches_autograd_and_jax(shape, F):
    rng = np.random.default_rng(4)
    C = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, C, F)) / np.sqrt(9 * C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(F)).astype(np.float32)
    dy = rng.standard_normal((*shape[:3], F)).astype(np.float32)

    def grads(fn):
        xs = [t(v).requires_grad_() for v in (x, k, bias)]
        fn(*xs).backward(t(dy))
        return [v.grad for v in xs]

    func = grads(act_ringconv.ActRingConv.apply)
    plain = grads(lambda a, kk, b: act_ringconv.act_ringconv_plain(a, None, None, kk, b, apply_act=False))
    conv = jax_layers.RingConv(F)
    _, vjp = jax.vjp(lambda a, kk, b: conv.apply({"params": {"conv": {"kernel": kk, "bias": b}}}, a), x, k, bias)
    ref = vjp(jnp.asarray(dy))
    for name, f, p, r in zip(("dx", "dW", "d_bias"), func, plain, ref):
        close(f, r, what=f"{name} of the autograd.Function vs jax.vjp")
        close(f, p, what=f"{name} vs autograd of the plain version")
    # dx is the ring conv of dy with the flipped, transposed kernel
    close(act_ringconv.ring_conv_input_grad(t(dy), t(k)), ref[0])


def test_cpu_wrappers_are_the_differentiable_plain_versions():
    x = torch.randn(1, 2, 8, 8, requires_grad=True)
    y = gn_silu.fused_group_norm_silu(x, torch.ones(8), torch.zeros(8), 4, 1e-6)
    z = act_ringconv.fused_act_ringconv(y, None, None, torch.randn(3, 3, 8, 8), torch.zeros(8), apply_act=False)
    assert y.grad_fn is not None and z.grad_fn is not None
    z.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


# --------------------------------------------------------------- (b) loss
@pytest.fixture(scope="module")
def jax_loss_and_grads(tiny):
    net, variables = tiny
    out = {}
    for objective in ("eps", "v"):
        ddpm = JaxContinuous(model=net, prediction_type=objective)
        x_0, steps, noise = batch(5)
        mask = (np.random.default_rng(6).uniform(size=x_0.shape) < 0.7).astype(np.float32)

        def loss(params):
            return ddpm.p_loss({"params": params, "buffers": variables["buffers"]}, x_0, steps, noise=noise,
                               loss_mask=mask)

        out[objective] = jax.jit(jax.value_and_grad(loss))(variables["params"])
    return out


@pytest.mark.parametrize("objective", ["eps", "v"])
def test_p_loss_and_gradients_match_jax(tiny, jax_loss_and_grads, objective):
    """eps and v prediction with a loss mask: min-SNR weight per sample."""
    _, variables = tiny
    ref_loss, ref_grads = jax_loss_and_grads[objective]
    net = port_net(variables)
    diffusion = ContinuousTimeGaussianDiffusion(net, prediction_type=objective)
    x_0, steps, noise = batch(5)
    mask = (np.random.default_rng(6).uniform(size=x_0.shape) < 0.7).astype(np.float32)
    loss = diffusion.p_loss(net, t(x_0), t(steps), t(noise), loss_mask=t(mask))
    loss.backward()
    close(loss, ref_loss, what="loss")
    ref = state_dict_from_jax({"params": ref_grads})
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(ref_grads))
    for name, p in net.named_parameters():
        # each gradient sums over every pixel: atol relative to the largest
        # gradient entry of the network (fp32 sums in another order)
        close(p.grad, ref[name], atol=ATOL * max(scale, 1.0), what=name)


# ------------------------------------------------------- (c) train steps
TRAIN = dict(lr=2e-3, lr_warmup_steps=2, num_steps=100)
EMA = dict(update_after_step=0, update_every=1)


@pytest.fixture(scope="module")
def jax_trainer(tiny):
    """The JAX package's jitted train step for TRAIN and EMA (one compile
    for every test of the module)."""
    ddpm = JaxContinuous(model=tiny[0])
    tx, _ = jax_make_optimizer(JaxTrainingConfig(**TRAIN))
    return ddpm, tx, jax.jit(jax_make_train_step(ddpm, tx, JaxEMAConfig(**EMA)))


def test_train_steps_match_jax(tiny, jax_trainer):
    """Three AdamW + EMA steps: warmup 2 (lr 0, then lr/2, then lr), the EMA
    copying at steps 0-1 and averaging from step 2, the gradients clipped
    (their norm is above 1 with these weights)."""
    _, variables = tiny
    variables = {"params": randomize(variables["params"], 2, std=0.3), "buffers": variables["buffers"]}
    ddpm, tx, jstep = jax_trainer
    jstate = jax_init_train_state(variables["params"], variables["buffers"], tx)

    model = port_net(variables)
    optimizer, scheduler = make_optimizer(model.parameters(), port_config.TrainingConfig(**TRAIN))
    state = init_train_state(model, optimizer, scheduler)
    pstep = make_train_step(ContinuousTimeGaussianDiffusion(model), optimizer, scheduler, EMAConfig(**EMA))

    x_0 = batch(7, B=4)[0]
    for i in range(3):
        key = jax.random.key(10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(x_0), key, None)
        # the steps and noise diffusion.loss draws from this key
        t_key, n_key = split_key(key)
        steps = np.asarray(ddpm.sample_timesteps(t_key, 4))
        noise = np.asarray(jax_normal(n_key, x_0.shape))
        pm = pstep(state, t(x_0), steps=t(steps), noise=t(noise))
        close(pm["loss"], jm["loss"], what=f"loss, step {i}")
        # the clip divides by norm + 1e-6 where optax divides by norm: a
        # relative 1e-6 / norm, well inside rtol
        close(pm["grad_norm"], jm["grad_norm"], what=f"grad norm, step {i}")
        assert float(jm["grad_norm"]) > 1.0
        assert pm["ema_decay"] == pytest.approx(float(jm["ema_decay"]), abs=1e-7)
        assert state.step == int(jstate.step) == i + 1
        params = state_dict_from_jax({"params": jstate.params})
        emas = state_dict_from_jax({"params": jstate.ema_params})
        ema_sd = dict(state.ema_model.named_parameters())
        for name, p in model.named_parameters():
            # Adam divides by sqrt(v) + 1e-8: a gradient entry within fp32
            # noise of 0 moves its parameter by up to lr either way, so the
            # parameters are held to lr-scaled atol (2e-3 x 1e-2)
            close(p, params[name], atol=2e-5, what=f"{name}, step {i}")
            close(ema_sd[name], emas[name], atol=2e-5, what=f"EMA {name}, step {i}")


# ------------------------------------------------- (d) schedules
def test_lr_schedule_and_ema_decay_match_jax():
    fn = cosine_schedule_with_warmup(10_000, 300_000)
    ref = jax_schedule(1e-4, 10_000, 300_000)
    for step in [0, 1, 500, 9_999, 10_000, 150_000, 299_999, 300_000]:
        assert 1e-4 * fn(step) == pytest.approx(float(ref(step)), rel=1e-5, abs=1e-12), step
    # the optimiser's lr at update k is lr(k): lr(0) = 0 first, as optax's
    # count-based schedule gives
    p = torch.nn.Parameter(torch.zeros(2))
    optimizer, scheduler = make_optimizer([p], port_config.TrainingConfig(lr=1e-3, lr_warmup_steps=4, num_steps=20))
    for k in range(6):
        # optax's schedule is fp32, LambdaLR's float64
        assert optimizer.param_groups[0]["lr"] == pytest.approx(float(jax_schedule(1e-3, 4, 20)(k)), rel=1e-6, abs=1e-12)
        optimizer.step()
        scheduler.step()
    for step in [0, 100, 101, 102, 103, 500, 10_000_000]:
        assert ema_decay(step, EMAConfig(beta=0.995)) == float(jax_ema_decay(jnp.asarray(step), JaxEMAConfig(beta=0.995)))


# --------------------------------------- (d') accumulation and grad_bf16
ACCUM = 2  # optax MultiSteps(tx, 2)


def _jax_draws(ddpm, key, x_0):
    """The steps and noise diffusion.loss draws from ``key``."""
    t_key, n_key = split_key(key)
    return np.asarray(ddpm.sample_timesteps(t_key, x_0.shape[0])), np.asarray(jax_normal(n_key, x_0.shape))


def _same_tree(got, ref, what):
    """The same nested keys, and every leaf within rtol and an atol scaled by
    the leaf's largest value (sums over pixels in another order)."""
    assert isinstance(got, dict) == isinstance(ref, dict), what
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), f"{what}: keys {sorted(got)} != {sorted(ref)}"
        for k in ref:
            _same_tree(got[k], ref[k], f"{what}/{k}")
        return
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype, f"{what}: {got.shape} {got.dtype} vs {ref.shape} {ref.dtype}"
    close(got, ref, atol=ATOL * max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-3), what=what)


@pytest.fixture(scope="module")
def jax_accum_trainer(tiny):
    """The JAX train step with optax MultiSteps(tx, ACCUM)."""
    ddpm = JaxContinuous(model=tiny[0])
    tx, _ = jax_make_optimizer(JaxTrainingConfig(**TRAIN, gradient_accumulation_steps=ACCUM))
    return ddpm, tx, jax.jit(jax_make_train_step(ddpm, tx, JaxEMAConfig(**EMA)))


def _accum_state(variables):
    model = port_net(variables)
    optimizer, scheduler = make_optimizer(model.parameters(), port_config.TrainingConfig(**TRAIN))
    state = init_train_state(model, optimizer, scheduler, accumulation_steps=ACCUM)
    return state, make_train_step(ContinuousTimeGaussianDiffusion(model), optimizer, scheduler, EMAConfig(**EMA))


def _check_against_jax(state, jstate, what):
    params = state_dict_from_jax({"params": jstate.params})
    emas = state_dict_from_jax({"params": jstate.ema_params})
    ema_sd = dict(state.ema_model.named_parameters())
    for name, p in state.model.named_parameters():
        # lr-scaled atol, as in test_train_steps_match_jax
        close(p, params[name], atol=2e-5, what=f"{name}, {what}")
        close(ema_sd[name], emas[name], atol=2e-5, what=f"EMA {name}, {what}")


def test_accumulation_matches_optax_multisteps(tiny, jax_accum_trainer):
    """k = 2 over 4 calls: the running mean, the clip and AdamW on calls 2
    and 4 only (lr(0) = 0, then lr(1)), the parameters still in between,
    the EMA on every call at the micro-step count, the logged gradient norm
    the call's own, and the optimizer state leaf by leaf in optax's layout."""
    _, variables = tiny
    variables = {"params": randomize(variables["params"], 2, std=0.3), "buffers": variables["buffers"]}
    ddpm, tx, jstep = jax_accum_trainer
    jstate = jax_init_train_state(variables["params"], variables["buffers"], tx)
    state, pstep = _accum_state(variables)
    for i in range(4):
        x_0 = batch(40 + i, B=4)[0]
        key = jax.random.key(50 + i)
        before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        jstate, jm = jstep(jstate, jnp.asarray(x_0), key, None)
        steps, noise = _jax_draws(ddpm, key, x_0)
        pm = pstep(state, t(x_0), steps=t(steps), noise=t(noise))
        close(pm["loss"], jm["loss"], what=f"loss, call {i}")
        close(pm["grad_norm"], jm["grad_norm"], what=f"grad norm, call {i}")
        assert pm["ema_decay"] == pytest.approx(float(jm["ema_decay"]), abs=1e-7)
        assert (state.step, state.updates, state.mini_step) == (i + 1, (i + 1) // ACCUM, (i + 1) % ACCUM)
        assert int(jstate.opt_state.gradient_step) == state.updates and int(jstate.opt_state.mini_step) == state.mini_step
        if i % ACCUM == 0:  # no update: the parameters did not move
            for n, p in state.model.named_parameters():
                assert torch.equal(p.detach(), before[n]), n
        _check_against_jax(state, jstate, f"call {i}")
        ref = serialization.to_state_dict(jax.tree.map(np.asarray, jstate.opt_state))
        _same_tree(checkpoint.optax_opt_state(state), ref, f"opt_state after call {i}")
    moved = max(float((p.detach() - before[n]).abs().max()) for n, p in state.model.named_parameters())
    assert moved > 1e-4  # the 4th call updated with lr(1)


def test_port_resumes_mid_accumulation_from_jax(tiny, jax_accum_trainer, tmp_path):
    """A JAX checkpoint at mini_step 1 (3 calls of k = 2) into the port: the
    counts, the running mean and AdamW's moments; then one more call on
    each side gives the same parameters."""
    _, variables = tiny
    ddpm, tx, jstep = jax_accum_trainer
    jstate = jax_init_train_state(variables["params"], variables["buffers"], tx)
    for i in range(3):
        jstate, _ = jstep(jstate, jnp.asarray(batch(60 + i, B=4)[0]), jax.random.key(70 + i), None)
    path = str(tmp_path / "jax.msgpack")
    jax_checkpoint.save_checkpoint(
        path, {}, {"params": jstate.params, "buffers": jstate.buffers},
        ema_weights={"params": jstate.ema_params, "buffers": jstate.buffers},
        opt_state=jax.tree.map(np.asarray, jstate.opt_state), step=int(jstate.step),
    )
    state, pstep = _accum_state(variables)
    assert resume(state, path) == 3
    assert (state.step, state.updates, state.mini_step) == (3, 1, 1)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(2e-3 * cosine_schedule_with_warmup(2, 100)(1))
    acc = state_dict_from_jax({"params": jstate.opt_state.acc_grads})
    for (name, _), a in zip(state.model.named_parameters(), state.acc_grads):
        np.testing.assert_array_equal(a.numpy(), acc[name].numpy(), err_msg=name)
    x_0, key = batch(63, B=4)[0], jax.random.key(73)
    jstate, _ = jstep(jstate, jnp.asarray(x_0), key, None)
    steps, noise = _jax_draws(ddpm, key, x_0)
    pstep(state, t(x_0), steps=t(steps), noise=t(noise))
    assert state.updates == int(jstate.opt_state.gradient_step) == 2
    _check_against_jax(state, jstate, "the call after the resume")


def test_jax_resumes_mid_accumulation_from_the_port(tiny, jax_accum_trainer, tmp_path):
    """The port's checkpoint at mini_step 1 into the JAX trainer's restore
    (flax from_state_dict into the MultiSteps template), then one more call
    on each side; a plain-AdamW state into an accumulating run raises."""
    _, variables = tiny
    ddpm, tx, jstep = jax_accum_trainer
    state, pstep = _accum_state(variables)
    for i in range(3):
        pstep(state, t(batch(80 + i, B=4)[0]), torch.Generator().manual_seed(i))
    path = checkpoint.save_checkpoint(str(tmp_path / "port.msgpack"), {}, state)
    ck = jax_checkpoint.load_checkpoint(path)
    opt = jax_checkpoint.restore_opt_state(tx.init(variables["params"]), ck["opt_state"])
    assert (int(opt.mini_step), int(opt.gradient_step), int(opt.inner_opt_state[1][0].count)) == (1, 1, 1)
    jstate = jax_init_train_state(variables["params"], variables["buffers"], tx).replace(
        params=jax.tree.map(jnp.asarray, ck["weights"]["params"]),
        ema_params=jax.tree.map(jnp.asarray, ck["ema_weights"]["params"]),
        opt_state=opt, step=jnp.asarray(ck["global_step"], jnp.int32),
    )
    x_0, key = batch(83, B=4)[0], jax.random.key(93)
    jstate, _ = jstep(jstate, jnp.asarray(x_0), key, None)
    steps, noise = _jax_draws(ddpm, key, x_0)
    pstep(state, t(x_0), steps=t(steps), noise=t(noise))
    _check_against_jax(state, jstate, "the call after the resume")

    plain = _trained_state(variables)
    path = checkpoint.save_checkpoint(str(tmp_path / "plain.msgpack"), {}, plain)
    with pytest.raises(ValueError, match="gradient_accumulation_steps=2"):
        resume(_accum_state(variables)[0], path)
    with pytest.raises(ValueError, match="MultiSteps"):
        load = checkpoint.load_checkpoint(str(tmp_path / "port.msgpack"))
        checkpoint.load_opt_state(_trained_state(variables, steps=0), load["opt_state"])


@pytest.fixture(scope="module")
def bf16_nets(tiny):
    """The tiny network in bf16 compute, JAX and port, the same weights."""
    _, variables = tiny
    return JaxUNet(dtype=jnp.bfloat16, **TINY), variables


def test_grad_bf16_steps_match_jax(bf16_nets, monkeypatch):
    """Two steps of the bf16-cotangent policy against make_train_step(
    grad_dtype=bf16), with JAX's GN + SiLU pass in fp32 (its gn_bf16=False,
    what the port's kernel computes). Both are bf16 networks whose roundings
    differ. The loss agrees to 1e-4 relative (limit 1e-3). The gradient
    norm does to 4.2e-2 (limit 6e-2): the same bf16 network with fp32
    cotangents differs as much between the frameworks (the bias gradients,
    sums over every pixel), while the port's bf16 and fp32 cotangents agree
    to 5.2e-4 (limit 1e-3; 2.1e-4 with the two-op down path, whose rounding
    differs). Each parameter to 4 lr (Adam moves a parameter
    by up to lr a step either way, so a gradient entry within rounding of
    0 may move it 2 lr the other way; measured 3.6 lr), the update direction
    to a cosine of 0.99 (0.9985). The gradients the port hands the clip are
    bf16 values."""
    monkeypatch.setattr(jax_layers, "GN_ACT_COMPUTE_DTYPE", jnp.float32)
    net, variables = bf16_nets
    ddpm = JaxContinuous(model=net)
    cfg = dict(lr=2e-3, lr_warmup_steps=0, num_steps=100)
    tx, _ = jax_make_optimizer(JaxTrainingConfig(**cfg))
    jstep = jax.jit(jax_make_train_step(ddpm, tx, JaxEMAConfig(**EMA), grad_dtype=jnp.bfloat16))
    jstate = jax_init_train_state(variables["params"], variables["buffers"], tx)

    model = EfficientUNet(dtype=torch.bfloat16, **TINY)
    model.load_state_dict(state_dict_from_jax(variables))
    optimizer, scheduler = make_optimizer(model.parameters(), port_config.TrainingConfig(**cfg, grad_bf16=True))
    state = init_train_state(model, optimizer, scheduler)
    pstep = make_train_step(ContinuousTimeGaussianDiffusion(model), optimizer, scheduler, EMAConfig(**EMA),
                            grad_dtype=torch.bfloat16)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    x_0 = batch(100, B=4)[0]
    steps, noise = _jax_draws(ddpm, jax.random.key(110), x_0)
    state.model.zero_grad()
    state.model.train()
    pstep_loss = ContinuousTimeGaussianDiffusion(model).p_loss(model, t(x_0), t(steps), t(noise))
    pstep_loss.backward()
    fp32_cotangent_norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()]))
    clip = torch.nn.utils.clip_grad_norm_
    handed = []  # the gradients as the clip receives them

    def recording_clip(params, max_norm):
        handed.append([p.grad.clone() for p in params])
        return clip(params, max_norm)

    monkeypatch.setattr(torch.nn.utils, "clip_grad_norm_", recording_clip)
    for i in range(2):
        x_0 = batch(100 + i, B=4)[0]
        key = jax.random.key(110 + i)
        jstate, jm = jstep(jstate, jnp.asarray(x_0), key, None)
        steps, noise = _jax_draws(ddpm, key, x_0)
        pm = pstep(state, t(x_0), steps=t(steps), noise=t(noise))
        close(pm["loss"], jm["loss"], rtol=1e-3, atol=0, what=f"loss, step {i}")
        close(pm["grad_norm"], jm["grad_norm"], rtol=6e-2, atol=0, what=f"grad norm, step {i}")
        if i == 0:
            close(pm["grad_norm"], fp32_cotangent_norm, rtol=1e-3, atol=0, what="bf16 against fp32 cotangents")
        assert len(handed[-1]) == len(list(model.parameters()))
        for g in handed[-1]:
            assert g.dtype == torch.float32 and torch.equal(g, g.bfloat16().float())
    params = state_dict_from_jax({"params": jstate.params})
    dots = n_port = n_jax = 0.0
    for name, p in model.named_parameters():
        close(p, params[name], rtol=0, atol=4 * 2e-3, what=name)
        d_port, d_jax = p.detach() - start[name], params[name] - start[name]
        dots += float((d_port * d_jax).sum())
        n_port += float((d_port * d_port).sum())
        n_jax += float((d_jax * d_jax).sum())
    assert dots / (n_port * n_jax) ** 0.5 > 0.99


def test_grad_bf16_requires_bf16_compute():
    """As the JAX trainer (train.py:286-290); with bf16 compute it builds."""
    p = [torch.nn.Parameter(torch.zeros(1))]
    with pytest.raises(ValueError, match="grad_bf16 requires mixed_precision='bf16'"):
        make_optimizer(p, port_config.TrainingConfig(grad_bf16=True, mixed_precision="no"))
    make_optimizer(p, port_config.TrainingConfig(grad_bf16=True))


# ------------------------------------------------------------ (e) dropout
def test_dropout_modes_generators_and_scale(tiny):
    _, variables = tiny
    sd = state_dict_from_jax(variables)
    net0 = EfficientUNet(**TINY)
    net0.load_state_dict(sd)
    net = EfficientUNet(dropout=0.3, **TINY)
    net.load_state_dict(sd)
    x, steps, _ = batch(8)
    with torch.no_grad():
        assert torch.equal(net.eval()(t(x), t(steps)), net0.eval()(t(x), t(steps)))
        net.train()

        def run(seed):
            return net(t(x), t(steps), generator=torch.Generator().manual_seed(seed))

        a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, net0(t(x), t(steps)))
    # keep rate 1 - p and scale 1 / (1 - p), as flax nn.Dropout
    h = torch.ones(200_000)
    y = layers.apply_dropout(h, 0.3, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 5e-3
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    cfg = port_config.Config()
    cfg.model.dropout = 0.1
    assert all(rb.dropout == 0.1 for rb in build_model(cfg, device="cpu").modules()
               if isinstance(rb, layers.ResidualBlock))


# --------------------------------------------------------- (f) checkpoints
def test_msgpack_writer_matches_the_msgpack_package():
    payload = {
        "cfg": "{}", "step": 70_000, "neg": [-1, -200, -70_000, -(2 ** 40)], "f": 1.5, "none": None,
        "flags": [True, False], "long": "x" * 300, "bin": b"z" * 70_000, "empty": {},
        "a": np.arange(6, dtype=np.float32).reshape(2, 3)[:, ::2], "c": np.asarray(3, np.int32),
        "s": np.float32(2.5), "many": {str(i): i for i in range(20)},
    }
    ref = msgpack.packb(payload, default=serialization._msgpack_ext_pack, strict_types=False)
    assert checkpoint.packb(payload) == ref
    back = serialization.msgpack_restore(checkpoint.packb(payload))
    assert back["c"].shape == () and back["s"] == 2.5


def test_jax_from_state_dict_inverts_state_dict_from_jax(tiny):
    _, variables = tiny
    tree = jax_from_state_dict(state_dict_from_jax(variables))
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    back = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat] == [p for p, _ in back]
    for (path, a), (_, b) in zip(flat, back):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))


def _trained_state(variables, steps=2):
    model = port_net(variables)
    optimizer, scheduler = make_optimizer(model.parameters(), port_config.TrainingConfig(**TRAIN))
    state = init_train_state(model, optimizer, scheduler)
    step = make_train_step(ContinuousTimeGaussianDiffusion(model), optimizer, scheduler, EMAConfig(**EMA))
    for i in range(steps):
        step(state, t(batch(20 + i)[0]), torch.Generator().manual_seed(i))
    return state


def test_checkpoint_written_by_the_port_loads_in_both_packages(tiny, tmp_path):
    net, variables = tiny
    state = _trained_state(variables)
    cfg = port_config.Config()
    cfg.model.base_channels, cfg.model.channel_multiplier = 8, (1, 2, 2, 2)
    cfg.model.num_residual_blocks, cfg.model.gn_num_groups = (1, 1, 1, 1), 4
    cfg.model.attn_num_heads, cfg.model.coords_encoding = 2, None
    cfg.data.resolution = (16, 64)
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpt.msgpack"), port_config.asdict(cfg), state)

    # the JAX package: load_checkpoint + restore_opt_state into its chain
    ck = jax_checkpoint.load_checkpoint(path)
    assert ck["global_step"] == 2 and ck["cfg"]["model"]["base_channels"] == 8
    for tree, module in ((ck["weights"], state.model), (ck["ema_weights"], state.ema_model)):
        sd = state_dict_from_jax(tree)
        for name, v in module.state_dict().items():
            np.testing.assert_array_equal(sd[name].numpy(), v.numpy(), err_msg=name)
    tx, _ = jax_make_optimizer(JaxTrainingConfig())
    opt = jax_checkpoint.restore_opt_state(tx.init(variables["params"]), ck["opt_state"])
    assert int(opt[1][0].count) == 2 and int(opt[1][2].count) == 2
    mu = state_dict_from_jax({"params": opt[1][0].mu})
    nu = state_dict_from_jax({"params": opt[1][0].nu})
    for name, p in state.model.named_parameters():
        np.testing.assert_array_equal(mu[name].numpy(), state.optimizer.state[p]["exp_avg"].numpy())
        np.testing.assert_array_equal(nu[name].numpy(), state.optimizer.state[p]["exp_avg_sq"].numpy())
    # and the JAX network runs the written weights as the port does
    x, steps, _ = batch(9)
    ref = jax.jit(net.apply)({"params": ck["ema_weights"]["params"], "buffers": ck["ema_weights"]["buffers"]}, x, steps)

    # the port: setup_model on the same file (EMA weights)
    ddpm, _, cfg2 = setup_model(path, device="cpu")
    assert cfg2.model.base_channels == 8
    with torch.no_grad():
        got = ddpm.model(t(x), t(steps))
        close(got, state.ema_model(t(x), t(steps)), rtol=0, atol=0)
    close(got, ref, what="JAX forward of the written EMA weights")


def test_port_resumes_from_a_jax_training_checkpoint(tiny, jax_trainer, tmp_path):
    _, variables = tiny
    _, tx, jstep = jax_trainer
    jstate = jax_init_train_state(variables["params"], variables["buffers"], tx)
    for i in range(3):
        jstate, _ = jstep(jstate, jnp.asarray(batch(30 + i)[0]), jax.random.key(i), None)
    path = str(tmp_path / "jax.msgpack")
    jax_checkpoint.save_checkpoint(
        path, {}, {"params": jstate.params, "buffers": jstate.buffers},
        ema_weights={"params": jstate.ema_params, "buffers": jstate.buffers},
        opt_state=jax.tree.map(np.asarray, jstate.opt_state), step=int(jstate.step),
    )
    model = EfficientUNet(**TINY)
    optimizer, scheduler = make_optimizer(model.parameters(), port_config.TrainingConfig(**TRAIN))
    state = init_train_state(model, optimizer, scheduler)
    assert resume(state, path) == 3 and state.step == 3
    assert optimizer.param_groups[0]["lr"] == pytest.approx(2e-3 * cosine_schedule_with_warmup(2, 100)(3))
    params = state_dict_from_jax({"params": jstate.params})
    emas = state_dict_from_jax({"params": jstate.ema_params})
    mu = state_dict_from_jax({"params": jstate.opt_state[1][0].mu})
    ema_sd = dict(state.ema_model.named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[name].numpy(), err_msg=name)
        np.testing.assert_array_equal(ema_sd[name].numpy(), emas[name].numpy(), err_msg=name)
        st = optimizer.state[p]
        assert float(st["step"]) == 3.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[name].numpy(), err_msg=name)
