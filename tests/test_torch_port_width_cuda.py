"""Card-only tests of the width axis's kernel forms: the ring conv's halo'd
form, GroupNorm's stats + apply pair and the int8 lane's halo'd quantize
pass against their plain versions, with their launch counts, at config-H
shapes with W halved (a rank's share under ``--mesh 1x2``); and a one-rank
width group refusing nothing it should run.

They skip without a CUDA device. This file imports no JAX, so on a machine
with the card and without JAX it runs as
``python -m pytest --noconftest -m cuda tests/test_torch_port_width_cuda.py``.
"""

import pytest
import torch

from r2dm_tpu_torch.ops import act_ringconv, gn_silu, quant

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


def _randn(shape, dev, seed, dtype=torch.float32, scale=1.0, offset=0.0):
    g = torch.Generator(dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale + offset).to(dtype)


@pytest.mark.parametrize("shape", [(64, 64, 64, 512), (128, 64, 64, 512), (256, 256, 16, 128), (512, 512, 8, 64),
                                   (64, 64, 8, 100)])
@pytest.mark.parametrize("act", [False, True])
def test_halo_conv_matches_its_plain_version(dev, shape, act):
    """The halo'd form reads pixel -1 and pixel W from the strips and writes
    W columns: max|err| <= 1e-2 max|ref| in bf16 (the ring form's gate), one
    launch counted apart from the ring form's."""
    C, Fo, H, W = shape
    x = _randn((4, H, W, C), dev, 1, torch.bfloat16)
    left, right = _randn((4, H, 1, C), dev, 2, torch.bfloat16), _randn((4, H, 1, C), dev, 3, torch.bfloat16)
    k = _randn((3, 3, C, Fo), dev, 4, scale=(9 * C) ** -0.5)
    bias = _randn((Fo,), dev, 5, scale=0.1)
    a, b = _randn((4, C), dev, 6, scale=0.5, offset=1.0), _randn((4, C), dev, 7, scale=0.2)
    ring, halo = act_ringconv.fused_act_ringconv.launches, act_ringconv.act_ringconv_halo.launches
    y = act_ringconv.fused_act_ringconv(x, a, b, k, bias, apply_act=act, halo=(left, right))
    torch.cuda.synchronize()
    assert act_ringconv.act_ringconv_halo.launches == halo + 1 and act_ringconv.fused_act_ringconv.launches == ring
    ref = act_ringconv.act_ringconv_plain(x, a, b, k, bias, apply_act=act, halo=(left, right))
    assert (y.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    # strips that are the ring's own columns give the ring form
    ring_y = act_ringconv.fused_act_ringconv(x, a, b, k, bias, apply_act=act)
    own = act_ringconv.fused_act_ringconv(x, a, b, k, bias, apply_act=act,
                                          halo=(x[:, :, -1:].contiguous(), x[:, :, :1].contiguous()))
    assert torch.equal(own, ring_y)


@pytest.mark.parametrize("shape", [(64, 64, 512), (128, 32, 256), (512, 8, 64), (256, 8, 64)])
@pytest.mark.parametrize("per_batch", [False, True])
def test_gn_stats_and_apply_match_their_plain_versions(dev, shape, per_batch):
    """The stats launch's fp32 sums to 1e-5 relative; the apply launch from
    sums of twice the pixels (two ranks' worth) against its plain version,
    rtol = atol = 2e-2 in bf16; one launch each."""
    C, H, W = shape
    x = _randn((4, H, W, C), dev, 8, torch.bfloat16, offset=0.1)
    aff = (4, C) if per_batch else (C,)
    gain, shift = _randn(aff, dev, 9, scale=0.5, offset=1.0), _randn(aff, dev, 10, scale=0.5)
    counts = (gn_silu.gn_stats.launches, gn_silu.gn_apply.launches, gn_silu.fused_group_norm_silu.launches)
    sums = gn_silu.gn_stats(x)
    ref = gn_silu.gn_stats_plain(x)
    assert ((sums - ref).abs() / ref.abs().clamp_min(1.0)).max().item() <= 1e-5
    both = sums * 2
    count = H * W * 2 * (C // 8)
    for silu in (True, False):
        y = gn_silu.gn_apply(x, both, count, gain, shift, 8, 1e-6, silu)
        want = gn_silu.gn_apply_plain(x, both, count, gain, shift, 8, 1e-6, silu)
        err = (y.float() - want.float()).abs()
        assert bool((err <= 2e-2 + 2e-2 * want.float().abs()).all())
    torch.cuda.synchronize()
    assert (gn_silu.gn_stats.launches, gn_silu.gn_apply.launches, gn_silu.fused_group_norm_silu.launches) == (
        counts[0] + 1, counts[1] + 2, counts[2])
    # one rank's own sums and count: the one-launch form's function
    y = gn_silu.gn_apply(x, sums, H * W * (C // 8), gain, shift, 8, 1e-6, True)
    one = gn_silu.fused_group_norm_silu(x, gain, shift, 8, 1e-6, True)
    assert bool(((y.float() - one.float()).abs() <= 2e-2 + 2e-2 * one.float().abs()).all())


def _config_h_lane_sites(dev) -> list:
    """The distinct (H, W, C, x dtype) of the int8 lane's sites in a config-H
    forward on the card (bf16 network), from one b1 eager forward (the
    first call of a forward that replays a CUDA graph runs its Python twice,
    as the warm-up and into the capture)."""
    from r2dm_tpu_torch import config as config_lib
    from r2dm_tpu_torch.inference import build_model
    from r2dm_tpu_torch.models import layers

    net = layers.set_quant_conv(build_model(config_lib.Config(), dtype=torch.bfloat16, device=dev), "w8a8")
    sites, real = [], layers.ring_conv_w8a8

    def recorded(x, kernel, bias, out_dtype=None, packed=None, width=None):
        sites.append((*x.shape[1:], x.dtype))
        return real(x, kernel, bias, out_dtype, packed, width=width)

    layers.ring_conv_w8a8 = recorded
    try:
        with torch.inference_mode():
            net._forward(torch.zeros(1, 64, 1024, 2, device=dev), torch.zeros(1, device=dev))
    finally:
        layers.ring_conv_w8a8 = real
    assert len(sites) == 53
    return sorted(set(sites), key=str)


def test_halo_quantize_matches_its_plain_version_at_every_site(dev):
    """The quantize pass's halo'd form at every config-H site shape of the
    int8 lane with W halved, b8: the s8 layout bit for bit against its
    plain version (columns 0 and W + 1 from the strips, ties on half steps
    to even, the padded channels zero); one launch each, counted apart from
    the ring form's; strips that are x's own edge columns give the ring
    form."""
    for H, W, C, dtype in _config_h_lane_sites(dev):
        Wl = W // 2
        x = _randn((8, H, Wl, C), dev, 11, dtype, scale=1.5)
        flat = x.view(-1)
        flat[::7] = ((torch.arange(flat.numel(), device=dev) % 9 - 4) + 0.5)[::7].to(dtype)
        flat[0] = 127.0  # the scale is then 1 in fp32, and every seventh value a tie
        left, right = _randn((8, H, 1, C), dev, 12, dtype, scale=1.5), _randn((8, H, 1, C), dev, 13, dtype, scale=1.5)
        left.view(-1)[::5] = 2.5
        amax = quant.act_absmax(x)
        counts = (quant.act_quantize.launches, quant.act_quantize_halo.launches)
        xq = quant.act_quantize(x, amax, halo=(left, right))
        torch.cuda.synchronize()
        assert (quant.act_quantize.launches, quant.act_quantize_halo.launches) == (counts[0], counts[1] + 1)
        assert tuple(xq.shape) == (8, H, Wl + 2, quant.padded_channels(C)), (H, W, C)
        assert torch.equal(xq, quant.act_quantize_plain(x, amax, halo=(left, right))), (H, W, C, dtype)
        own = quant.act_quantize(x, amax, halo=(x[:, :, -1:].contiguous(), x[:, :, :1].contiguous()))
        assert torch.equal(own, quant.act_quantize(x, amax)), (H, W, C, dtype)
