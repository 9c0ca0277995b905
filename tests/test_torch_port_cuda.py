"""Card-only tests of the port's CUDA kernels: each against its plain
version, the launch counters, and that a CUDA tensor the kernel does not take
raises instead of reaching the plain version.

They skip without a CUDA device. This file imports no JAX, so on a machine
with the card and without JAX it runs as
``python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py``.
"""

import pytest
import torch

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


@pytest.mark.parametrize("shape,groups", [((2, 16, 64, 64), 8), ((3, 8, 128, 512), 8), ((2, 4, 24, 40), 5)])
@pytest.mark.parametrize("per_batch", [False, True])
def test_gn_kernels_match_plain(dev, shape, groups, per_batch):
    B, C = shape[0], shape[-1]
    x = _randn(shape, dev, 0, torch.bfloat16)
    aff = (B, C) if per_batch else (C,)
    gain, shift = _randn(aff, dev, 1), _randn(aff, dev, 2)
    n = gn_silu.gn_coeffs.launches
    a, b = gn_silu.gn_coeffs(x, groups, 1e-6, gain, shift)
    assert gn_silu.gn_coeffs.launches == n + 1
    a_ref, b_ref = gn_silu.gn_coeffs_plain(x, groups, 1e-6, gain, shift)
    torch.testing.assert_close(a, a_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(b, b_ref, rtol=1e-4, atol=1e-5)
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


def test_cuda_tensors_never_reach_the_plain_version(dev):
    x = torch.zeros((1, 4, 16, 16), device=dev)  # fp32: the kernels take bf16
    k = torch.zeros((3, 3, 16, 16), device=dev)
    ab = torch.zeros((1, 16), device=dev)
    n = act_ringconv.fused_act_ringconv.launches
    with pytest.raises(TypeError):
        act_ringconv.fused_act_ringconv(x, ab, ab, k, torch.zeros(16, device=dev))
    with pytest.raises(TypeError):
        gn_silu.gn_coeffs(x, 4, 1e-6, ab[0], ab[0])
    with pytest.raises(ValueError):  # not contiguous
        xb = torch.zeros((1, 4, 32, 16), device=dev, dtype=torch.bfloat16)[:, :, ::2]
        gn_silu.fused_group_norm_silu(xb, ab[0], ab[0], 4, 1e-6)
    shifted = torch.zeros(1 + 4 * 16 * 16, device=dev, dtype=torch.bfloat16)[1:].view(1, 4, 16, 16)
    with pytest.raises(ValueError):  # not on a 16-byte boundary
        act_ringconv.fused_act_ringconv(shifted, ab, ab, k.to(torch.bfloat16), torch.zeros(16, device=dev))
    with pytest.raises(ValueError):
        gn_silu.gn_coeffs(shifted, 4, 1e-6, ab[0], ab[0])
    assert act_ringconv.fused_act_ringconv.launches == n
