"""Card-only tests of the int8 lane's CUDA kernels (``csrc/w8a8_ringconv.cu``):
the quantize pass bit for bit against its plain version, the s8 ring conv
against its plain version at ragged shapes (the s32 sums equal, the fp32 and
bf16 outputs equal), the absmax reduction against ``x.abs().max()`` and with
a NaN, the launch counters (one absmax, one quantize and one s8 conv a
quantized conv), refusals, and a tiny network under the lane.

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
# (below, above and at the 128-pixel tile; above the 256-pixel one), C_in %
# 8 != 0 (the quantize pass's scalar path), F past one 64-channel tile (the
# fragment-stored epilogue) and whole tiles (the staged one), H = 1 and 2
# (both kernel rows of padding), the deepest config-H level
SHAPES = [
    ((2, 5, 40, 34, 64), torch.float32), ((2, 4, 200, 64, 2), torch.bfloat16),
    ((1, 3, 128, 64, 64), torch.bfloat16), ((3, 2, 7, 17, 3), torch.float32),
    ((2, 1, 130, 8, 70), torch.bfloat16), ((1, 2, 64, 128, 128), torch.float32),
    ((2, 8, 128, 512, 512), torch.bfloat16), ((1, 6, 33, 40, 10), torch.bfloat16),
    ((1, 3, 300, 64, 64), torch.bfloat16), ((2, 2, 256, 24, 70), torch.float32),
]


def _counts() -> tuple:
    return quant.ring_conv_w8a8.launches, quant.act_absmax.launches, quant.act_quantize.launches


@pytest.mark.parametrize("shape,x_dtype", SHAPES)
def test_quantize_kernel_matches_plain(dev, shape, x_dtype):
    """The s8 values, the ring columns and the zero channels of the conv's
    operand, bit for bit; ties on half steps round to even."""
    B, H, W, C, _ = shape
    x = _randn((B, H, W, C), dev, 6, x_dtype, scale=1.5)
    flat = x.view(-1)
    flat[::7] = ((torch.arange(flat.numel(), device=dev) % 9 - 4) + 0.5)[::7].to(x_dtype)
    flat[0] = 127.0  # the scale is then 1 in fp32, and every seventh value a tie
    amax = quant.act_absmax(x)
    n = _counts()
    xq = quant.act_quantize(x, amax)
    torch.cuda.synchronize()
    assert _counts() == (n[0], n[1], n[2] + 1)
    assert xq.dtype == torch.int8 and tuple(xq.shape) == (B, H, W + 2, quant.padded_channels(C))
    assert torch.equal(xq, quant.act_quantize_plain(x, amax))
    assert torch.equal(xq[:, :, 1:W + 1, :C], quant.act_qparams(x)[0])


@pytest.mark.parametrize("shape,x_dtype", SHAPES)
def test_s8_kernel_matches_plain(dev, shape, x_dtype):
    B, H, W, C, F = shape
    x = _randn((B, H, W, C), dev, 1, x_dtype, scale=1.5)
    k = _randn((3, 3, C, F), dev, 2, scale=(9 * C) ** -0.5)
    bias = _randn((F,), dev, 3, scale=0.1)
    n = _counts()
    acc = quant.w8a8_accumulators(x, k)
    torch.cuda.synchronize()
    assert acc.dtype == torch.int32 and acc.is_cuda
    assert torch.equal(acc, quant.conv_s8(quant.act_qparams(x)[0], quant.weight_qparams(k)[0]))
    y32 = quant.ring_conv_w8a8(x, k, bias, out_dtype=torch.float32)
    assert torch.equal(y32, quant.ring_conv_w8a8_plain(x, k, bias, out_dtype=torch.float32))
    y16 = quant.ring_conv_w8a8(x, k, None, out_dtype=torch.bfloat16)
    ref16 = quant.ring_conv_w8a8_plain(x, k, None, out_dtype=torch.bfloat16)
    assert _bf16_steps(y16, ref16) == 0
    assert _counts() == (n[0] + 3, n[1] + 3, n[2] + 3)
    # the conv alone on the quantize pass's operand, against its plain version
    amax = quant.act_absmax(x)
    xq, packed = quant.act_quantize(x, amax), quant.pack_weight(k)
    for od in (torch.int32, torch.float32, torch.bfloat16):
        y = quant.ring_conv_s8(xq, amax, packed, bias, od)
        assert torch.equal(y, quant.ring_conv_s8_plain(xq, amax, packed, bias.float(), od))


def test_one_quantized_conv_is_three_launches(dev):
    x = _randn((2, 4, 64, 64), dev, 7, torch.bfloat16)
    k = _randn((3, 3, 64, 64), dev, 8, scale=0.05)
    packed = quant.pack_weight(k)
    ops.reset_launch_counts()
    quant.ring_conv_w8a8(x, k, None, packed=packed)
    assert {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS} == {
        "fused_group_norm_silu": 0, "fused_act_ringconv": 0, "ring_conv_w8a8": 1, "act_absmax": 1,
        "act_quantize": 1, "act_ringconv_halo": 0, "gn_stats": 0, "gn_apply": 0,
        "act_quantize_halo": 0}
    quant.ring_conv_w8a8(x, k, None, packed=packed, amax=quant.act_absmax(x))  # the caller's absmax
    assert _counts() == (2, 2, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_nan_makes_the_lane_output_all_nan(dev, dtype):
    """One NaN in x: the absmax is NaN (fmaxf would drop it), so the scale
    is, and every output value, as from the plain version and the JAX
    package."""
    x = _randn((2, 4, 136, 34), dev, 9, dtype)
    x[1, 2, 77, 5] = float("nan")
    k = _randn((3, 3, 34, 8), dev, 10, scale=0.05)
    assert torch.isnan(quant.act_absmax(x)).item()
    tail = torch.ones(13, device=dev, dtype=dtype)
    tail[12] = float("nan")  # past the last 8-value vector
    assert torch.isnan(quant.act_absmax(tail)).item()
    y = quant.ring_conv_w8a8(x, k, _randn((8,), dev, 11))
    assert bool(torch.isnan(y).all())
    assert bool(torch.isnan(quant.ring_conv_w8a8_plain(x, k, None)).all())


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
    n = _counts()
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
    xq = torch.zeros((1, 4, 10, 64), device=dev, dtype=torch.int8)
    with pytest.raises(ValueError):  # an s8 operand of another Cp than the packed weight's
        quant.ring_conv_s8(xq[..., :32].contiguous(), torch.ones((), device=dev), quant.pack_weight(k), None,
                           torch.float32)
    with pytest.raises(TypeError):  # no fp16 output
        quant.ring_conv_s8(xq, torch.ones((), device=dev), quant.pack_weight(k), None, torch.float16)
    assert _counts() == n


def test_tiny_network_under_the_lane_on_the_card(dev, monkeypatch):
    """Every quantizable conv launches the absmax, quantize and s8 kernels
    (21 each a forward of this net, the JAX package's count:
    tests/test_torch_port_quant.py), the bf16 ring conv none; the forward equals the same network with the plain
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
    import chip_smoke

    with torch.inference_mode():
        net(x, cond)  # packs the weights, and captures the forward's CUDA graph
        packed = [m._packed[1][0].data_ptr() for m in net.modules() if isinstance(m, layers.RingConv) and m.quant]
        with chip_smoke.device_launches(torch) as ran:  # the replay's kernels, as they ran on the card
            y = net(x, cond)
        launches = ran.counts
        assert launches == {"fused_group_norm_silu": 18, "fused_act_ringconv": 0, "ring_conv_w8a8": 21,
                            "act_absmax": 21, "act_quantize": 21, "act_ringconv_halo": 0, "gn_stats": 0, "gn_apply": 0,
                            "act_quantize_halo": 0}
        assert packed == [m._packed[1][0].data_ptr() for m in net.modules()
                          if isinstance(m, layers.RingConv) and m.quant]
        monkeypatch.setattr(layers, "ring_conv_w8a8",
                            lambda x, kernel, bias, out_dtype=None, packed=None, width=None:
                            quant.ring_conv_w8a8_plain(x, kernel, bias, out_dtype))
        ref = net(x, cond)
    assert bool(torch.isfinite(y).all())
    assert torch.equal(y, ref)
