"""Card-only tests of the training slice: both kernel wrappers under
autograd (a graph node on a CUDA tensor, the prologue form raising), their
gradients against autograd of the plain versions, ``loss.backward()``
through one ResidualBlock and one config-H train step, kernel path against
plain path.

They skip without a CUDA device. This file imports no JAX, so on a machine
with the card and without JAX it runs as
``python -m pytest --noconftest -m cuda tests/test_torch_port_training_cuda.py``.
"""

import copy

import pytest
import torch

from r2dm_tpu_torch import config as config_lib
from r2dm_tpu_torch import ops
from r2dm_tpu_torch.bench import random_ddpm
from r2dm_tpu_torch.models import layers
from r2dm_tpu_torch.ops import act_ringconv, gn_silu
from r2dm_tpu_torch.training import EMAConfig, init_train_state, make_optimizer, make_train_step

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dev, seed, dtype=torch.float32):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.fixture
def plain_path(monkeypatch):
    """Swap the network's two kernel calls for their plain versions."""

    def use():
        monkeypatch.setattr(layers, "fused_group_norm_silu", gn_silu.fused_group_norm_silu_plain)
        monkeypatch.setattr(layers, "fused_act_ringconv", act_ringconv.act_ringconv_plain)

    return use


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def test_wrappers_track_autograd_and_the_prologue_form_raises(dev):
    x = _randn((2, 4, 16, 64), dev, 0, torch.bfloat16).requires_grad_()
    ones, zeros = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    k = _randn((3, 3, 64, 64), dev, 1) * 0.05
    n = act_ringconv.fused_act_ringconv.launches
    y = gn_silu.fused_group_norm_silu(x, ones, zeros, 8, 1e-6)
    z = act_ringconv.fused_act_ringconv(y, None, None, k, zeros, apply_act=False)
    assert y.grad_fn is not None and z.grad_fn is not None
    z.float().sum().backward()
    assert act_ringconv.fused_act_ringconv.launches == n + 2  # forward, then dx
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    a = ones[None].expand(2, 64).contiguous()
    with pytest.raises(NotImplementedError, match="apply_act"):
        act_ringconv.fused_act_ringconv(x, a, torch.zeros_like(a), k, zeros, apply_act=True)
    with torch.no_grad():  # without grad the prologue form runs
        act_ringconv.fused_act_ringconv(x, a, torch.zeros_like(a), k, zeros, apply_act=True)


@pytest.mark.parametrize("per_batch", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 64, 64), (3, 8, 40, 128)])
def test_gn_backward_matches_plain_autograd(dev, shape, per_batch):
    B, C = shape[0], shape[-1]
    aff = (B, C) if per_batch else (C,)
    inputs = [_randn(shape, dev, 0, torch.bfloat16), 1 + 0.5 * _randn(aff, dev, 1), 0.5 * _randn(aff, dev, 2)]
    dy = _randn(shape, dev, 3, torch.bfloat16)

    def grads(fn):
        leaves = [v.clone().requires_grad_() for v in inputs]
        fn(*leaves, 8, 1e-6, True).backward(dy)
        return [v.grad for v in leaves]

    for got, ref in zip(grads(gn_silu.fused_group_norm_silu), grads(gn_silu.fused_group_norm_silu_plain)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shape,F", [((2, 8, 64, 64), 64), ((2, 4, 96, 128), 72), ((1, 3, 40, 16), 24)])
def test_ring_conv_backward_matches_plain_autograd(dev, shape, F):
    C = shape[-1]
    inputs = [_randn(shape, dev, 0, torch.bfloat16), _randn((3, 3, C, F), dev, 1) * (9 * C) ** -0.5,
              0.1 * _randn((F,), dev, 2)]
    dy = _randn((*shape[:3], F), dev, 3, torch.bfloat16)

    def grads(fn):
        leaves = [v.clone().requires_grad_() for v in inputs]
        fn(leaves[0], None, None, leaves[1], leaves[2], apply_act=False).backward(dy)
        return [v.grad for v in leaves]

    for got, ref in zip(grads(act_ringconv.fused_act_ringconv), grads(act_ringconv.act_ringconv_plain)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 1e-2 * ref.float().abs().max().item(), err


def test_residual_block_backward_matches_plain_path(dev, plain_path):
    """loss.backward() through one ResidualBlock on the card gives every
    parameter the plain path's gradient (bf16 compute: relative L2 <= 2e-2,
    the forward's limit)."""
    torch.manual_seed(0)
    blk = layers.ResidualBlock(64, 128, emb_channels=256, dtype=torch.bfloat16).to(dev)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn_like(p) * 0.05)
    x = _randn((2, 16, 64, 64), dev, 1, torch.bfloat16)
    emb = _randn((2, 256), dev, 2)

    def grads(b):
        b.zero_grad(set_to_none=True)
        b(x, emb).float().square().mean().backward()
        return {n: p.grad for n, p in b.named_parameters()}

    got = grads(blk)
    plain_blk = copy.deepcopy(blk)
    plain_path()
    ref = grads(plain_blk)
    assert set(got) == set(ref)
    for name in ref:
        assert got[name] is not None and float(ref[name].norm()) > 0, name
        assert _rel(got[name], ref[name]) <= 2e-2, (name, _rel(got[name], ref[name]))


def test_config_h_train_step_matches_plain_path(dev, plain_path):
    """One config-H b2 train step (loss, backward, clip, AdamW, EMA) through
    the kernels and through the plain versions from the same weights, batch,
    steps and noise: the loss and the gradient norm within 2e-2, and the
    launch counts of the kernel path (50 GN + 96 conv)."""
    ddpm = random_ddpm(seed=1)
    g = torch.Generator(dev).manual_seed(2)
    x_0 = torch.rand((2, 64, 1024, 2), generator=g, device=dev) * 2 - 1
    steps = torch.rand((2,), generator=g, device=dev)
    noise = torch.randn((2, 64, 1024, 2), generator=g, device=dev)

    def one_step(model):
        optimizer, scheduler = make_optimizer(model.parameters(), config_lib.TrainingConfig(lr_warmup_steps=0))
        state = init_train_state(model, optimizer, scheduler)
        step = make_train_step(ddpm.diffusion, optimizer, scheduler, EMAConfig())
        return step(state, x_0, steps=steps, noise=noise), state

    plain_model = copy.deepcopy(ddpm.model)
    ops.reset_launch_counts()
    got, state = one_step(ddpm.model)
    assert {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS} == {
        "fused_group_norm_silu": 50, "fused_act_ringconv": 96, "ring_conv_w8a8": 0, "act_absmax": 0,
        "act_quantize": 0, "act_ringconv_halo": 0, "gn_stats": 0, "gn_apply": 0,
        "act_quantize_halo": 0}
    plain_path()
    ref, plain_state = one_step(plain_model)
    assert abs(got["loss"].item() - ref["loss"].item()) <= 2e-2 * abs(ref["loss"].item())
    assert abs(got["grad_norm"].item() - ref["grad_norm"].item()) <= 2e-2 * ref["grad_norm"].item()
    assert state.step == plain_state.step == 1
    assert all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
