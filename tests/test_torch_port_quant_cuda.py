"""Card-only tests of the int8 lane's CUDA kernels (``csrc/w8a8_ringconv.cu``):
the s8 ring conv against its plain version at ragged shapes (the s32 sums
equal, the fp32 output equal, the bf16 output within one bf16 step), the
absmax reduction against ``x.abs().max()``, the launch counters, refusals,
and a tiny network under the lane.

They skip without a CUDA device. This file imports no JAX, so on a machine
with the card and without JAX it runs as
``python -m pytest --noconftest -m cuda tests/test_torch_port_quant_cuda.py``.
"""

import pytest
import torch

from r2dm_tpu_torch import ops
from r2dm_tpu_torch.models import layers
from r2dm_tpu_torch.models.efficient_unet import EfficientUNet
from r2dm_tpu_torch.ops import quant

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


def _randn(shape, dev, seed, dtype=torch.float32, scale=1.0):
    g = torch.Generator(dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _bf16_steps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two bf16 tensors in representable
    steps (same sign; both finite)."""
    ia, ib = (t.view(torch.int16).to(torch.int32) for t in (a.contiguous(), b.contiguous()))
    return int((ia - ib).abs().max().item()) if a.numel() else 0


# (B, H, W, C_in, F): in_conv (C_in 34, fp32 x), out_conv (F 2), ragged W
# (below, above and at the 128-pixel tile), C_in % 8 != 0 (the scalar
# staging), F past one 64-channel tile, H = 1 and 2 (both kernel rows of
# padding), the deepest config-H level
SHAPES = [
    ((2, 5, 40, 34, 64), torch.float32), ((2, 4, 200, 64, 2), torch.bfloat16),
    ((1, 3, 128, 64, 64), torch.bfloat16), ((3, 2, 7, 17, 3), torch.float32),
    ((2, 1, 130, 8, 70), torch.bfloat16), ((1, 2, 64, 128, 128), torch.float32),
    ((2, 8, 128, 512, 512), torch.bfloat16), ((1, 6, 33, 40, 10), torch.bfloat16),
]


@pytest.mark.parametrize("shape,x_dtype", SHAPES)
def test_s8_kernel_matches_plain(dev, shape, x_dtype):
    B, H, W, C, F = shape
    x = _randn((B, H, W, C), dev, 1, x_dtype, scale=1.5)
    k = _randn((3, 3, C, F), dev, 2, scale=(9 * C) ** -0.5)
    bias = _randn((F,), dev, 3, scale=0.1)
    n, n_max = quant.ring_conv_w8a8.launches, quant.act_absmax.launches
    acc = quant.w8a8_accumulators(x, k)
    torch.cuda.synchronize()
    assert acc.dtype == torch.int32 and acc.is_cuda
    assert torch.equal(acc, quant.conv_s8(quant.act_qparams(x)[0], quant.weight_qparams(k)[0]))
    y32 = quant.ring_conv_w8a8(x, k, bias, out_dtype=torch.float32)
    assert torch.equal(y32, quant.ring_conv_w8a8_plain(x, k, bias, out_dtype=torch.float32))
    y16 = quant.ring_conv_w8a8(x, k, None, out_dtype=torch.bfloat16)
    ref16 = quant.ring_conv_w8a8_plain(x, k, None, out_dtype=torch.bfloat16)
    assert _bf16_steps(y16, ref16) <= 1
    assert quant.ring_conv_w8a8.launches == n + 3 and quant.act_absmax.launches == n_max + 3


@pytest.mark.parametrize("numel", [1, 7, 8, 4096 + 3, 8 * 64 * 1024 * 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_absmax_kernel_is_the_max_of_abs(dev, numel, dtype):
    x = _randn((numel,), dev, 4, dtype)
    x[numel // 2] = -7.25  # the largest magnitude, negative
    n = quant.act_absmax.launches
    got = quant.act_absmax(x)
    assert quant.act_absmax.launches == n + 1
    assert got.dtype == torch.float32 and got.dim() == 0
    assert got.item() == x.float().abs().max().item() == 7.25


def test_the_kernels_refuse_what_they_do_not_take(dev):
    n, n_max = quant.ring_conv_w8a8.launches, quant.act_absmax.launches
    k = torch.zeros((3, 3, 16, 8), device=dev)
    with pytest.raises(TypeError):  # fp16 activations
        quant.ring_conv_w8a8(torch.zeros((1, 4, 8, 16), device=dev, dtype=torch.float16), k, None)
    with pytest.raises(ValueError):  # not contiguous
        quant.ring_conv_w8a8(torch.zeros((1, 4, 16, 16), device=dev)[:, :, ::2], k, None)
    shifted = torch.zeros(1 + 4 * 8 * 16, device=dev, dtype=torch.bfloat16)[1:].view(1, 4, 8, 16)
    with pytest.raises(ValueError):  # not on a 16-byte boundary
        quant.ring_conv_w8a8(shifted, k, None)
    with pytest.raises(ValueError):  # a kernel of another C_in
        quant.ring_conv_w8a8(torch.zeros((1, 4, 8, 8), device=dev), k, None)
    with pytest.raises(ValueError):  # a packed weight of another kernel
        quant.ring_conv_w8a8(torch.zeros((1, 4, 8, 16), device=dev), k, None, packed=quant.pack_weight(k[..., :4]))
    with pytest.raises(RuntimeError, match="inference-only"):
        quant.ring_conv_w8a8(torch.zeros((1, 4, 8, 16), device=dev, requires_grad=True), k, None)
    assert quant.ring_conv_w8a8.launches == n and quant.act_absmax.launches == n_max


def test_tiny_network_under_the_lane_on_the_card(dev, monkeypatch):
    """Every quantizable conv launches the s8 kernel (21 a forward of this
    net, the JAX package's count: tests/test_torch_port_quant.py), the bf16
    ring conv none; the forward equals the same network with the plain
    version in the lane's place, and the packed weights are made once."""
    torch.manual_seed(0)
    net = EfficientUNet(in_channels=2, resolution=(16, 128), base_channels=16, channel_multiplier=(1, 2, 2, 2),
                        num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2,
                        dtype=torch.bfloat16)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(0.1 * torch.randn(p.shape))
    net = layers.set_quant_conv(net.to(dev).eval(), "w8a8")
    x = _randn((3, 16, 128, 2), dev, 5)
    cond = torch.tensor([0.1, 0.5, 0.9], device=dev)
    with torch.inference_mode():
        net(x, cond)  # packs the weights
        packed = [m._packed[1][0].data_ptr() for m in net.modules() if isinstance(m, layers.RingConv) and m.quant]
        ops.reset_launch_counts()
        y = net(x, cond)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
        assert launches == {"fused_group_norm_silu": 18, "fused_act_ringconv": 0, "ring_conv_w8a8": 21,
                            "act_absmax": 21}
        assert packed == [m._packed[1][0].data_ptr() for m in net.modules()
                          if isinstance(m, layers.RingConv) and m.quant]
        monkeypatch.setattr(layers, "ring_conv_w8a8",
                            lambda x, kernel, bias, out_dtype=None, packed=None:
                            quant.ring_conv_w8a8_plain(x, kernel, bias, out_dtype))
        ref = net(x, cond)
    assert bool(torch.isfinite(y).all())
    assert torch.equal(y, ref)
