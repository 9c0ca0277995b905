"""Card-only tests of the port's CUDA kernels: each against its plain
version, the launch counters, and that a CUDA tensor the kernel does not take
raises instead of reaching the plain version.

They skip without a CUDA device. This file imports no JAX, so on a machine
with the card and without JAX it runs as
``python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py``.
"""

import pytest
import torch

from r2dm_tpu_torch import ops
from r2dm_tpu_torch.models import layers
from r2dm_tpu_torch.ops import act_ringconv, gn_silu

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


# config-H-like shapes, then: H*W < CLUSTER (empty shares), C = 8, C = 2048,
# B = 1, B = 9 (more clusters than fit at once), G = 5 (ranks >= G only
# wait), G = 32 > CLUSTER (a rank owns two groups)
@pytest.mark.parametrize("shape,groups", [
    ((2, 16, 64, 64), 8), ((3, 8, 128, 512), 8), ((2, 4, 24, 40), 5), ((2, 1, 5, 16), 4),
    ((2, 4, 8, 8), 2), ((2, 2, 8, 2048), 8), ((1, 8, 16, 64), 8), ((9, 8, 128, 64), 8),
    ((2, 3, 11, 64), 32),
])
@pytest.mark.parametrize("per_batch", [False, True])
def test_gn_kernels_match_plain(dev, shape, groups, per_batch):
    B, C = shape[0], shape[-1]
    x = _randn(shape, dev, 0, torch.bfloat16)
    aff = (B, C) if per_batch else (C,)
    gain, shift = _randn(aff, dev, 1), _randn(aff, dev, 2)
    for silu in (True, False):
        n = gn_silu.fused_group_norm_silu.launches
        y = gn_silu.fused_group_norm_silu(x, gain, shift, groups, 1e-6, apply_silu=silu)
        assert gn_silu.fused_group_norm_silu.launches == n + 1
        ref = gn_silu.fused_group_norm_silu_plain(x, gain, shift, groups, 1e-6, apply_silu=silu)
        torch.testing.assert_close(y.float(), ref.float(), rtol=2e-2, atol=2e-2)


# (B, H, W, C_in), F, shift of b. The kernel's tile is 128 pixels x 64
# channels x 32 input channels a slice: one block (the descriptor check),
# W < 128 and W % 128 != 0, C_in % 32 != 0, F % 64 != 0, H = 1 and 2 with
# silu(b) far from 0 (a non-zero H-pad row would show), B = 1 and 3.
@pytest.mark.parametrize("shape,F,b_shift", [
    ((2, 8, 64, 64), 64, 0.0), ((2, 4, 96, 128), 72, 0.0), ((1, 3, 40, 16), 24, 0.0),
    ((1, 1, 128, 32), 64, 0.0), ((3, 2, 200, 72), 24, 4.0), ((1, 1, 40, 24), 72, 4.0),
    ((1, 2, 256, 64), 128, 4.0),
])
@pytest.mark.parametrize("apply_act", [True, False])
def test_act_ringconv_kernel_matches_plain(dev, shape, F, b_shift, apply_act):
    B, C = shape[0], shape[-1]
    x = _randn(shape, dev, 0, torch.bfloat16)
    a = 1.0 + 0.5 * _randn((B, C), dev, 1)
    b = b_shift + 0.2 * _randn((B, C), dev, 2)
    k = _randn((3, 3, C, F), dev, 3) * (9 * C) ** -0.5
    bias = 0.1 * _randn((F,), dev, 4)
    n = act_ringconv.fused_act_ringconv.launches
    y = act_ringconv.fused_act_ringconv(x, a, b, k, bias, apply_act=apply_act)
    assert act_ringconv.fused_act_ringconv.launches == n + 1
    ref = act_ringconv.act_ringconv_plain(x, a, b, k, bias, apply_act=apply_act)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item(), err


@pytest.mark.parametrize("apply_silu", [True, False])
def test_gn_kernels_are_deterministic(dev, apply_silu):
    """The fold adds the CTAs' sums in rank order, with no atomics: two
    calls give bitwise equal results."""
    x = _randn((8, 16, 256, 128), dev, 5, torch.bfloat16)
    gain, shift = _randn((8, 128), dev, 6), _randn((8, 128), dev, 7)
    y1 = gn_silu.fused_group_norm_silu(x, gain, shift, 8, 1e-6, apply_silu=apply_silu)
    y2 = gn_silu.fused_group_norm_silu(x, gain, shift, 8, 1e-6, apply_silu=apply_silu)
    assert torch.equal(y1, y2)


def _silu_tail_input(dev, B=2, H=8, W=128, C=64):
    """x whose normalised values run evenly over [-sqrt(3), sqrt(3)] in every
    channel with a group mean of 0, and a gain that maps them onto
    z = x*a + b in [-10, 10] (shift 0, so z has no cancellation)."""
    grid = torch.linspace(-1.0, 1.0, H * W).to(torch.bfloat16)
    x = torch.stack([grid.roll(37 * c) for c in range(C)], dim=-1)
    x = x.reshape(1, H, W, C).expand(B, H, W, C).contiguous().to(dev)
    gain = torch.full((C,), 10.0 / 3.0 ** 0.5, device=dev)
    return x, gain, torch.zeros(C, device=dev)


def test_gn_silu_is_accurate_in_both_tails(dev):
    """The kernel's SiLU against the plain fp32 y*sigmoid(y) over
    z in [-10, 10]: at most one bf16 step apart (both round an fp32 value
    to bf16 once, so a step is all that may separate them), including the
    negative tail where sigmoid(z) is small."""
    x, gain, shift = _silu_tail_input(dev)
    y = gn_silu.fused_group_norm_silu(x, gain, shift, 8, 1e-6).float()
    ref = gn_silu.fused_group_norm_silu_plain(x, gain, shift, 8, 1e-6).float()
    z = gn_silu.fused_group_norm_silu_plain(x, gain, shift, 8, 1e-6, apply_silu=False).float()
    assert z.min().item() < -9.9 and z.max().item() > 9.9
    bad = (y - ref).abs() > 2.0 ** -7 * ref.abs()
    assert not bool(bad.any()), (z[bad][:8].tolist(), y[bad][:8].tolist(), ref[bad][:8].tolist())


def test_gn_clusters_fit_the_card(dev):
    """Config H at b8 runs 8 clusters at once (128 of 132 SMs)."""
    for C in (64, 128, 256, 512):
        assert gn_silu.max_active_clusters(C) >= 8


def test_residual_block_writes_the_activation_once(dev, monkeypatch):
    """A ResidualBlock forward on the card: GN+SiLU and AdaGN+SiLU through
    the GroupNorm kernel and both convs without their prologue; it matches the same block on the plain
    versions (bf16: max|err| <= 1e-2 * max|ref|)."""
    torch.manual_seed(0)
    blk = layers.ResidualBlock(64, 128, emb_channels=256, dtype=torch.bfloat16)
    with torch.no_grad():
        for prm in blk.parameters():  # conv2 is zero-initialised
            prm.copy_(0.05 * torch.randn(prm.shape))
    blk = blk.to(dev)
    x = _randn((2, 8, 128, 64), dev, 8, torch.bfloat16)
    emb = _randn((2, 256), dev, 9)
    before = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    with torch.no_grad():
        y = blk(x, emb)
    launched = {fn.__name__: fn.launches - before[fn.__name__] for fn in ops.KERNEL_WRAPPERS}
    assert launched == {"fused_group_norm_silu": 2, "fused_act_ringconv": 2}
    monkeypatch.setattr(layers, "fused_group_norm_silu", gn_silu.fused_group_norm_silu_plain)
    monkeypatch.setattr(layers, "fused_act_ringconv", act_ringconv.act_ringconv_plain)
    with torch.no_grad():
        ref = blk(x, emb)
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item(), err


def test_cuda_tensors_never_reach_the_plain_version(dev):
    x = torch.zeros((1, 4, 16, 16), device=dev)  # fp32: the kernels take bf16
    k = torch.zeros((3, 3, 16, 16), device=dev)
    ab = torch.zeros((1, 16), device=dev)
    n = act_ringconv.fused_act_ringconv.launches
    with pytest.raises(TypeError):
        act_ringconv.fused_act_ringconv(x, ab, ab, k, torch.zeros(16, device=dev))
    n_gn = gn_silu.fused_group_norm_silu.launches
    with pytest.raises(TypeError):
        gn_silu.fused_group_norm_silu(x, ab[0], ab[0], 4, 1e-6)
    with pytest.raises(ValueError):  # not contiguous
        xb = torch.zeros((1, 4, 32, 16), device=dev, dtype=torch.bfloat16)[:, :, ::2]
        gn_silu.fused_group_norm_silu(xb, ab[0], ab[0], 4, 1e-6)
    shifted = torch.zeros(1 + 4 * 16 * 16, device=dev, dtype=torch.bfloat16)[1:].view(1, 4, 16, 16)
    with pytest.raises(ValueError):  # not on a 16-byte boundary
        act_ringconv.fused_act_ringconv(shifted, ab, ab, k.to(torch.bfloat16), torch.zeros(16, device=dev))
    with pytest.raises(ValueError):
        gn_silu.fused_group_norm_silu(shifted, ab[0], ab[0], 4, 1e-6)
    assert act_ringconv.fused_act_ringconv.launches == n
    assert gn_silu.fused_group_norm_silu.launches == n_gn
