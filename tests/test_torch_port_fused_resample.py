"""The port's conv∘FIR composition (r2dm_tpu_torch/ops/fused_resample.py)
against the JAX package's (r2dm_tpu/ops/fused_resample.py) and against the
port's own two-op form, on the CPU: values in fp32 and bf16, the composed
bf16 kernel bit for bit, gradients against ``jax.grad``, a tiny network
with ``FUSED_RESAMPLE = "down"`` against the same network with it off and
against JAX's default network, the kernel cache across an optimizer step,
and the int8 lane leaving the composed convs unquantized."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2dm_tpu.models.efficient_unet import EfficientUNet as JaxUNet
from r2dm_tpu.ops import fused_resample as jax_fr
from r2dm_tpu_torch.models import layers
from r2dm_tpu_torch.models.efficient_unet import EfficientUNet
from r2dm_tpu_torch.ops import fused_resample as fr
from r2dm_tpu_torch.ops.pad import ring_pad
from r2dm_tpu_torch.ops.resample import downsample2x, upsample2x
from r2dm_tpu_torch.utils.weights import state_dict_from_jax

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

TINY = dict(in_channels=2, resolution=(16, 64), base_channels=8, channel_multiplier=(1, 2, 2, 2),
            num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2,
            coords_encoding="fourier_features")
# JAX's own shapes (tests/test_fused_resample.py:25), and one at 64 channels
SHAPES = [(2, 8, 16, 3), (1, 16, 32, 5), (2, 8, 32, 64)]


def _kernel_scale(ci: int) -> float:
    """JAX's test scale (0.3) at its shapes; at 64 channels the network's
    own (LeCun, 1/sqrt(9 C_in)), which keeps the output O(1): with 0.3 the
    outputs reach 4 and the fp32 sums of 2304 products, added in another
    order, differ by up to 1.5e-5 between any two correct lowerings."""
    return 0.3 if ci < 64 else (9 * ci) ** -0.5


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _operands(shape, seed, co=6):
    rng = np.random.default_rng(seed)
    B, H, W, Ci = shape
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, Ci, co)) * _kernel_scale(Ci)).astype(np.float32)
    b = (rng.standard_normal((co,)) * 0.5).astype(np.float32)
    return x, k, b


def _ring_conv(x, k, b):
    """The port's two-op form's conv: ring pad, then a 3x3 conv (NHWC)."""
    y = torch.nn.functional.conv2d(ring_pad(x, 1).permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), b)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("lowering", ["_cells_cudnn", "_cells_matmul"])
@pytest.mark.parametrize("shape", SHAPES)
def test_conv_then_downsample_matches_jax_and_the_two_op_form(shape, lowering, monkeypatch):
    """Both lowerings of the conv on 2x2 cells: the conv the card runs
    (here on the CPU) and the CPU's im2col matrix product."""
    monkeypatch.setattr(fr, "_cells_conv", getattr(fr, lowering))
    x, k, b = _operands(shape, 0)
    want = np.asarray(jax_fr.conv_then_downsample(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    with torch.no_grad():
        got = fr.conv_then_downsample(t(x), t(k), t(b))
        two_op = downsample2x(_ring_conv(t(x), t(k), t(b)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    np.testing.assert_allclose(got.numpy(), two_op.numpy(), atol=2e-6)


def test_the_cards_lowering_runs_one_sample_a_call(monkeypatch):
    """``_cells_cudnn`` hands cuDNN one sample a call, every call at one
    shape, so a sample's sums cannot depend on its row in the batch or on
    the batch size; it computes what the CPU's matrix product does."""
    x, k, _ = _operands((3, 8, 16, 5), 7)
    cells, weight = fr._s2d_cells(t(x)), fr.down_weight(t(k))
    shapes, conv2d = [], torch.nn.functional.conv2d

    def recorded(inp, *args, **kwargs):
        shapes.append(tuple(inp.shape))
        return conv2d(inp, *args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", recorded)
    got = fr._cells_cudnn(cells, weight)
    assert shapes == [(1, 20, 6, 10)] * 3
    np.testing.assert_allclose(got.numpy(), fr._cells_matmul(cells, weight).numpy(), atol=2e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_upsample_then_conv_matches_jax(shape):
    """atol 2e-6 at JAX's shapes. At 64 channels the outputs reach 3.3 and
    JAX's own lowerings of this function differ from each other by up to
    2.3e-6 (about 10 fp32 steps at that scale), so there the limit is 1e-6
    of the largest output (3.3e-6)."""
    h, k, b = _operands(shape, 1)
    want = np.asarray(jax_fr.upsample_then_conv(jnp.asarray(h), jnp.asarray(k), jnp.asarray(b)))
    atol = 2e-6 if shape[-1] < 64 else 1e-6 * float(np.abs(want).max())
    with torch.no_grad():
        got = fr.upsample_then_conv(t(h), t(k), t(b))
        two_op = _ring_conv(upsample2x(t(h)), t(k), t(b))
    np.testing.assert_allclose(got.numpy(), want, atol=atol)
    np.testing.assert_allclose(got.numpy(), two_op.numpy(), atol=atol)


def _bf16_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_composed_kernel_is_jax_bit_for_bit(shape):
    """The 6x6 kernels built in bf16 (eager JAX, one rounding an op) are
    equal bit for bit, up and down; the bf16 output is within 2e-2."""
    x, k, b = _operands(shape, 2)
    kj = jnp.asarray(k).astype(jnp.bfloat16)
    kt = t(k).to(torch.bfloat16)
    for scale in (1.0, 2.0):
        want = np.asarray(jax_fr._composed_kernel(kj, scale))
        got = fr._composed_kernel(kt, scale).view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got, _bf16_bits(want))
    want_row = np.asarray(jax_fr._row_composed_kernel(kj[0], 2.0))
    got_row = fr._row_composed_kernel(kt[0], 2.0).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got_row, _bf16_bits(want_row))
    want = np.asarray(jax_fr.conv_then_downsample(jnp.asarray(x, jnp.bfloat16), kj, jnp.asarray(b))).astype(np.float32)
    with torch.no_grad():
        got = fr.conv_then_downsample(t(x).to(torch.bfloat16), kt, t(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("op", ["down", "up"])
def test_gradients_match_jax_grad(op):
    x, k, b = _operands((2, 8, 16, 5), 3)
    jfn = jax_fr.conv_then_downsample if op == "down" else jax_fr.upsample_then_conv
    tfn = fr.conv_then_downsample if op == "down" else fr.upsample_then_conv
    w = np.random.default_rng(4).standard_normal(
        np.asarray(jfn(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))).shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k),
                                                                         jnp.asarray(b))
    xs, ks, bs = (t(a).requires_grad_() for a in (x, k, b))
    (tfn(xs, ks, bs) * t(w)).sum().backward()
    for got, ref in zip((xs.grad, ks.grad, bs.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_jax():
    """JAX's default network (FUSED_RESAMPLE = "down") on random weights,
    its output, and the weights as the port's state_dict."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 64, 2)).astype(np.float32)
    cond = np.array([0.3, -1.2], np.float32)
    jnet = JaxUNet(**TINY)
    variables = jnet.init(jax.random.key(0), jnp.zeros((1, 16, 64, 2)), jnp.zeros((1,)))
    prng = np.random.default_rng(6)
    variables = {"params": jax.tree.map(lambda l: prng.standard_normal(l.shape).astype(np.float32) * 0.1,
                                        variables["params"]),
                 "buffers": {"coords": np.asarray(variables["buffers"]["coords"])}}
    ref = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x), jnp.asarray(cond)))
    return x, cond, ref, state_dict_from_jax(variables)


def _tiny(sd, **kw) -> EfficientUNet:
    net = EfficientUNet(**TINY, **kw)
    net.load_state_dict(sd)
    return net


def test_tiny_net_composed_matches_two_op_and_jax(tiny_jax, monkeypatch):
    x, cond, ref, sd = tiny_jax
    net = _tiny(sd)
    assert layers.FUSED_RESAMPLE == "down"
    calls = fr.conv_then_downsample.calls
    with torch.no_grad():
        y = net(t(x), t(cond)).numpy()
        assert fr.conv_then_downsample.calls - calls == 3
        monkeypatch.setattr(layers, "FUSED_RESAMPLE", False)
        y_two_op = net(t(x), t(cond)).numpy()
        assert fr.conv_then_downsample.calls - calls == 3
        monkeypatch.setattr(layers, "FUSED_RESAMPLE", True)
        up_calls = fr.upsample_then_conv.calls
        y_both = net(t(x), t(cond)).numpy()
        assert fr.upsample_then_conv.calls - up_calls == 3
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(y, y_two_op, atol=1e-5)
    np.testing.assert_allclose(y_both, y_two_op, atol=1e-5)
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=2e-5)


def test_training_takes_dw_through_the_composition_and_the_cache_follows_the_weight(tiny_jax, monkeypatch):
    """Under grad the composed kernel is built in the graph (dW reaches the
    3x3 down-conv weight, equal to the two-op form's); without grad it is
    kept, and an optimizer step makes it again."""
    x, cond, _, sd = tiny_jax
    net = _tiny(sd)
    conv = net.d_block2.downsample[0]

    def grads():
        net.zero_grad()
        net(t(x), t(cond)).square().mean().backward()
        return conv.weight.grad.clone()

    g = grads()
    assert conv._composed is None  # a training forward keeps no kernel
    monkeypatch.setattr(layers, "FUSED_RESAMPLE", False)
    g_two_op = grads()
    monkeypatch.setattr(layers, "FUSED_RESAMPLE", "down")
    np.testing.assert_allclose(g.numpy(), g_two_op.numpy(), rtol=1e-4, atol=1e-6)
    assert float(g.abs().max()) > 0

    with torch.no_grad():
        net(t(x), t(cond))
    kept = conv._composed[1]
    torch.optim.SGD(net.parameters(), lr=0.5).step()
    with torch.no_grad():
        y = net(t(x), t(cond))
    assert conv._composed[1] is not kept
    k = conv.weight.detach().permute(2, 3, 1, 0)
    torch.testing.assert_close(conv._composed[1], fr.down_weight(k), rtol=0, atol=0)
    monkeypatch.setattr(layers, "FUSED_RESAMPLE", False)
    with torch.no_grad():
        y_two_op = net(t(x), t(cond))
    np.testing.assert_allclose(y.numpy(), y_two_op.numpy(), atol=1e-5)


@pytest.mark.parametrize("mode", ["down", "up", "both"])
def test_the_int8_lane_leaves_composed_convs_unquantized(tiny_jax, monkeypatch, mode):
    """JAX returns from a composed conv before its int8 branch: the three
    down convs are never quantized, the three up convs only while the up
    path runs two-op."""
    x, cond, _, sd = tiny_jax
    net = _tiny(sd)
    seen = []
    real = layers.ring_conv_w8a8

    def counted(xq, kernel, *a, **kw):
        seen.append(tuple(kernel.shape))
        return real(xq, kernel, *a, **kw)

    monkeypatch.setattr(layers, "ring_conv_w8a8", counted)
    monkeypatch.setattr(layers, "FUSED_RESAMPLE", mode)
    layers.set_quant_conv(net, "w8a8")
    with torch.no_grad():
        y = net(t(x), t(cond))
    assert bool(torch.isfinite(y).all())
    # 8 ResidualBlocks x 2 convs, in_conv and out_conv, and the up convs
    # unless they run composed
    assert len(seen) == 16 + 2 + (0 if mode in ("up", "both") else 3)
