"""The int8 (W8A8) serving lane of the port against the JAX package, on the
CPU: the quantization parameters and the plain ``ring_conv_w8a8`` bit for
bit against ``r2dm_tpu/ops/quant.py``, the convs the lane routes through it
counted against the JAX package's calls, a tiny network under the lane
against JAX's, autograd refused, the JAX package's batch chunking under the
lane, and ``generate --int8``, ``sample_and_save`` and ``bench`` under
``R2DM_TPU_INT8``. The CUDA kernels themselves are card-only
(``tests/test_torch_port_quant_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2dm_tpu.inference import DDPM as JaxDDPM
from r2dm_tpu.models import layers as jax_layers
from r2dm_tpu.models.efficient_unet import EfficientUNet as JaxUNet
from r2dm_tpu.ops import quant as jax_quant
from r2dm_tpu_torch import bench, generate, sample_and_save
from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch.checkpoint import write_checkpoint
from r2dm_tpu_torch.inference import DDPM, build_diffusion, build_model, model_coords, setup_model
from r2dm_tpu_torch.models import layers
from r2dm_tpu_torch.models.efficient_unet import EfficientUNet
from r2dm_tpu_torch.ops import quant
from r2dm_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax

torch.set_num_threads(1)

TINY = dict(in_channels=2, resolution=(16, 64), base_channels=8, channel_multiplier=(1, 2, 2, 2),
            num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2)
# the tiny network under the lane against JAX's under its lane, fp32, same
# weights and inputs, each running on its own: relative L2 of the output.
# Every site agrees bit for bit on the same input (the teacher-forced test),
# but the fp32 parts between them (GroupNorm, attention, resampling) agree to
# about 1e-7, and a value that close to a rounding tie flips by one step of
# its tensor's scale; each later quantized conv spreads that. JAX's own
# jitted and eager forwards of this network differ by up to 2.7e-2 for that
# reason (measured over two weight seeds and two weight scales), as much as
# the lane differs from the fp32 network (2.5e-2 to 3.7e-2).
FORWARD_REL_L2 = 5e-2


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16).astype(np.int32)


def _with_ties(rng, shape, scale):
    """Normal values times ``scale``, with a quarter of them moved onto
    rounding ties: the tensor's absmax is set to 127 (its scale is then 1 in
    fp32; ``scale`` keeps the rest below it), and those values to k + 0.5."""
    v = rng.standard_normal(shape).astype(np.float32) * scale
    flat = v.reshape(-1)
    ties = rng.choice(flat.size, flat.size // 4, replace=False)
    flat[ties] = rng.integers(-120, 120, ties.size) + 0.5
    flat[0] = 127.0
    return v


@pytest.mark.parametrize("ties", [False, True])
def test_qparams_equal_jax(ties):
    rng = np.random.default_rng(1)
    x = _with_ties(rng, (2, 5, 7, 34), 20.0) if ties else rng.standard_normal((2, 5, 7, 34)).astype(np.float32)
    k = rng.standard_normal((3, 3, 34, 6)).astype(np.float32) * 0.3
    if ties:  # every output channel's absmax 127, a quarter of its taps on ties
        k = np.stack([_with_ties(rng, (3, 3, 34), 20.0) for _ in range(6)], axis=-1)
    xq, xs = jax_quant.act_qparams(jnp.asarray(x))
    kq, ks = jax_quant.weight_qparams(jnp.asarray(k))
    pxq, pxs = quant.act_qparams(t(x))
    pkq, pks = quant.weight_qparams(t(k))
    assert pxq.dtype == pkq.dtype == torch.int8
    np.testing.assert_array_equal(pxq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(pkq.numpy(), np.asarray(kq))
    assert pxs.item() == float(xs)
    np.testing.assert_array_equal(pks.numpy(), np.asarray(ks))
    if ties:  # round half to even, as jnp.round
        assert set(np.unique(np.asarray(xq)[(np.abs(x) % 1) == 0.5] % 2)) == {0}


@pytest.mark.parametrize("B,H,W,C,F", [(2, 5, 12, 34, 2), (1, 4, 9, 8, 10), (2, 6, 16, 64, 64), (1, 3, 5, 17, 3)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_plain_ring_conv_w8a8_equals_jax(B, H, W, C, F, x_dtype):
    """fp32 output bit for bit; bf16 output too (the same fp32 value rounded
    once), tighter than the one bf16 ulp allowed; C_in and F ragged."""
    rng = np.random.default_rng(B * 1000 + C + F)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32) * 1.5
    k = rng.standard_normal((3, 3, C, F)).astype(np.float32) * 0.2
    b = rng.standard_normal(F).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == torch.bfloat16 else jnp.float32)
    px = t(x).to(x_dtype)
    for jod, pod in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax_quant.ring_conv_w8a8(jx, jnp.asarray(k), jnp.asarray(b), out_dtype=jod))
        got = quant.ring_conv_w8a8(px, t(k), t(b), out_dtype=pod)
        assert got.dtype == pod and tuple(got.shape) == (B, H, W, F)
        if pod == torch.float32:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_array_equal(_bf16_bits(got.float().numpy()), _bf16_bits(want.astype(np.float32)))
    # no bias, output in x's dtype
    want = np.asarray(jax_quant.ring_conv_w8a8(jx, jnp.asarray(k), None).astype(jnp.float32))
    np.testing.assert_array_equal(quant.ring_conv_w8a8(px, t(k), None).float().numpy(), want)


def test_accumulators_are_the_integer_ring_conv():
    """The s32 sums of the plain version against JAX's int8 conv of the
    materialized ring pad (tests/test_quant.py's reference), and the packed
    weight rebuilt as an implicit GEMM over (tap, channel) gives them too."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 16, 34)).astype(np.float32)
    k = rng.standard_normal((3, 3, 34, 10)).astype(np.float32) * 0.2
    xq, _ = jax_quant.act_qparams(jnp.asarray(x))
    kq, _ = jax_quant.weight_qparams(jnp.asarray(k))
    xp = jnp.pad(xq, ((0, 0), (0, 0), (1, 1), (0, 0)), mode="wrap")
    want = np.asarray(jax.lax.conv_general_dilated(
        xp, kq, (1, 1), ((1, 1), (0, 0)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    got = quant.w8a8_accumulators(t(x), t(k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    packed, ks = quant.pack_weight(t(k))
    assert packed.shape == (10, 9, quant.K_CHUNK) and packed.dtype == torch.int8
    assert not packed[:, :, 34:].any()
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jax_quant.weight_qparams(jnp.asarray(k))[1]))
    # implicit GEMM: column (kh*3 + kw, c) against the halo of the ring-padded xq
    pxq = quant.act_qparams(t(x))[0].to(torch.int64)
    pad = torch.nn.functional.pad(pxq.permute(0, 3, 1, 2), (1, 1, 0, 0), mode="circular")
    pad = torch.nn.functional.pad(pad, (0, 0, 1, 1)).permute(0, 2, 3, 1)  # (B, H+2, W+2, C)
    cols = torch.stack([pad[:, kh:kh + 6, kw:kw + 16] for kh in range(3) for kw in range(3)], dim=3)
    gemm = torch.einsum("bhwtc,ftc->bhwf", cols, packed[:, :, :34].to(torch.int64))
    np.testing.assert_array_equal(gemm.numpy(), want)


@pytest.mark.parametrize("C", [34, 8, 17, 64, 130])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ties", [False, True])
def test_quantize_pass_layout_equals_jax_qparams(C, x_dtype, ties):
    """The quantize pass's plain version (the CPU route of ``act_quantize``):
    s8 (B, H, W + 2, Cp) holding JAX's act_qparams values in columns 1..W,
    x's column W - 1 in column 0 and its column 0 in column W + 1 (the
    ring), zeros in channels C..Cp; ties round half to even."""
    rng = np.random.default_rng(C)
    x = _with_ties(rng, (2, 3, 7, C), 20.0) if ties else rng.standard_normal((2, 3, 7, C)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == torch.bfloat16 else jnp.float32)
    want = np.asarray(jax_quant.act_qparams(jx)[0])
    px = t(x).to(x_dtype)
    xq = quant.act_quantize(px, quant.act_absmax(px))
    cp = quant.padded_channels(C)
    assert xq.dtype == torch.int8 and tuple(xq.shape) == (2, 3, 9, cp) and cp % quant.K_CHUNK == 0 and cp >= C
    np.testing.assert_array_equal(xq[:, :, 1:8, :C].numpy(), want)
    np.testing.assert_array_equal(xq[:, :, 0, :C].numpy(), want[:, :, -1])
    np.testing.assert_array_equal(xq[:, :, 8, :C].numpy(), want[:, :, 0])
    assert not xq[..., C:].any()
    if ties:
        assert set(np.unique(want[(np.abs(x) % 1) == 0.5] % 2)) == {0}


@pytest.mark.parametrize("B,H,W,C,F", [(2, 5, 12, 34, 2), (1, 4, 9, 8, 10), (2, 6, 16, 64, 64), (1, 1, 5, 130, 3)])
def test_conv_of_the_padded_operands_equals_conv_s8(B, H, W, C, F):
    """The s8 conv's plain version on its own operands (the quantize pass's
    xq and the packed weight) gives conv_s8's sums and JAX's int8 conv of
    the materialized ring pad, and its epilogue the whole lane's output bit
    for bit in fp32 and bf16."""
    rng = np.random.default_rng(B * 100 + C)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    k = rng.standard_normal((3, 3, C, F)).astype(np.float32) * 0.2
    b = rng.standard_normal(F).astype(np.float32)
    amax = quant.act_absmax(t(x))
    xq, packed = quant.act_quantize(t(x), amax), quant.pack_weight(t(k))
    got = quant.conv_s8_padded(xq, packed[0])
    assert got.dtype == torch.int32
    assert torch.equal(got, quant.conv_s8(quant.act_qparams(t(x))[0], quant.weight_qparams(t(k))[0]))
    jxq, _ = jax_quant.act_qparams(jnp.asarray(x))
    jkq, _ = jax_quant.weight_qparams(jnp.asarray(k))
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.pad(jxq, ((0, 0), (0, 0), (1, 1), (0, 0)), mode="wrap"), jkq, (1, 1), ((1, 1), (0, 0)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(quant.ring_conv_s8(xq, amax, packed, None, torch.int32), got)
    for od in (torch.float32, torch.bfloat16):
        y = quant.ring_conv_s8(xq, amax, packed, t(b), od)
        assert y.dtype == od and torch.equal(y, quant.ring_conv_w8a8_plain(t(x), t(k), t(b), od))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_a_nan_in_x_makes_every_output_nan(x_dtype):
    """The reference side of the card's NaN check: one NaN in x makes the
    scale NaN, and the JAX function and the port's plain route both return
    an all-NaN output (the absmax kernel keeps the NaN to match)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 4, 8, 16)).astype(np.float32)
    x[0, 2, 5, 7] = np.nan
    k = rng.standard_normal((3, 3, 16, 4)).astype(np.float32) * 0.2
    b = rng.standard_normal(4).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == torch.bfloat16 else jnp.float32)
    want = np.asarray(jax_quant.ring_conv_w8a8(jx, jnp.asarray(k), jnp.asarray(b)).astype(jnp.float32))
    assert np.isnan(want).all()
    px = t(x).to(x_dtype)
    assert torch.isnan(quant.act_absmax(px)).item()
    assert bool(torch.isnan(quant.ring_conv_w8a8(px, t(k), t(b))).all())
    amax = quant.act_absmax(px)
    assert bool(torch.isnan(quant.ring_conv_s8(quant.act_quantize(px, amax), amax, quant.pack_weight(t(k)), t(b),
                                               torch.float32)).all())


@pytest.fixture(scope="module")
def tiny_pair():
    """(flax module, variables, port module) with the same random weights,
    every one N(0, 0.1^2) from numpy; the flax tree through
    ``jax_from_state_dict`` (no flax init to compile)."""
    net = EfficientUNet(coords_encoding="fourier_features", **TINY)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(t(rng.standard_normal(tuple(p.shape)) * 0.1))
    variables = jax_from_state_dict(net.state_dict())
    return JaxUNet(coords_encoding="fourier_features", **TINY), variables, net.eval()


def _jax_lane_run(jnet, variables, x, cond):
    """One jitted forward of the flax module with the JAX package's lane on:
    (output, (x shape, x dtype, out dtype) of each quant.ring_conv_w8a8
    call in order, and each call's (input, output)); the switch and the
    function restored in ``finally`` (tests/test_quant.py:90-95)."""
    meta, sites, real = [], [], jax_quant.ring_conv_w8a8

    def counted(x, kernel, bias, out_dtype=None):
        y = real(x, kernel, bias, out_dtype)
        meta.append((tuple(x.shape), jnp.dtype(x.dtype).name, jnp.dtype(y.dtype).name))
        sites.append((x, kernel, bias))
        return y

    def run(v, x, c):
        sites.clear()
        return jnet.apply(v, x, c), list(sites)

    assert jax_layers.QUANT_CONV is None
    jax_layers.QUANT_CONV = "w8a8"
    jax_quant.ring_conv_w8a8 = counted
    try:
        out, recorded = jax.jit(run)(variables, jnp.asarray(x), jnp.asarray(cond))
    finally:
        jax_layers.QUANT_CONV = None
        jax_quant.ring_conv_w8a8 = real
    return np.asarray(out, np.float32), meta, [tuple(np.asarray(a) for a in site) for site in recorded]


def _inputs():
    rng = np.random.default_rng(5)
    return rng.standard_normal((2, 16, 64, 2)).astype(np.float32), np.array([0.3, -1.0], np.float32)


@pytest.fixture(scope="module")
def jax_lane(tiny_pair):
    jnet, variables, _ = tiny_pair
    return _jax_lane_run(jnet, variables, *_inputs())


def _port_lane_run(net, x, cond, monkeypatch, site=None):
    """The port's forward with the lane on: (output, the (x shape, x dtype,
    out dtype) of each ring_conv_w8a8 call). ``site(x)``, when given,
    replaces each call's input."""
    meta, real = [], quant.ring_conv_w8a8

    def counted(x, kernel, bias, out_dtype=None, packed=None, width=None):
        x = site(x) if site else x
        y = real(x, kernel, bias, out_dtype, packed, width=width)
        meta.append((tuple(x.shape), str(x.dtype).split(".")[-1], str(y.dtype).split(".")[-1]))
        return y

    monkeypatch.setattr(layers, "ring_conv_w8a8", counted)
    layers.set_quant_conv(net, "w8a8")
    try:
        assert layers.quant_conv_mode(net) == "w8a8"
        with torch.no_grad():
            out = net(t(x), t(cond)).numpy()
    finally:
        layers.set_quant_conv(net, None)
    assert layers.quant_conv_mode(net) is None
    return out, meta


@pytest.mark.parametrize("bf16", [False, True])
def test_lane_routes_exactly_the_convs_jax_quantizes(tiny_pair, jax_lane, monkeypatch, bf16):
    """The same call sites, in the same order, each on an activation of the
    same shape and dtype (in_conv on the fp32 concat of the images and the
    encoding, in a bf16 network too) with the same output dtype; the down
    convs and the 1x1 skips stay out."""
    jnet, variables, net = tiny_pair
    jax_meta = jax_lane[1]
    if bf16:
        jax_meta = _jax_lane_run(jnet.clone(dtype=jnp.bfloat16), variables, *_inputs())[1]
        net = EfficientUNet(coords_encoding="fourier_features", dtype=torch.bfloat16, **TINY)
        net.load_state_dict(state_dict_from_jax(variables))
    _, meta = _port_lane_run(net, *_inputs(), monkeypatch)
    # 2 convs in each of the 8 ResidualBlocks, in/out conv, 3 up convs
    assert len(jax_meta) == 8 * 2 + 2 + 3
    assert meta == jax_meta
    assert [c for c in meta if c[1] == "float32"] == (meta if not bf16 else meta[:1])
    assert sum(m.quantizable for m in net.modules() if isinstance(m, layers.RingConv)) == len(meta)


def test_every_lane_site_equals_jax_on_its_input(tiny_pair, jax_lane, monkeypatch):
    """Teacher forcing: each call of the port's lane is handed the JAX
    package's input at that site (from the jitted JAX forward), and gives
    exactly what ``quant.ring_conv_w8a8`` gives on that input and that
    site's kernel and bias; the network's output, out_conv's, is then JAX's
    up to the jitted program's own rounding (XLA contracts the epilogue's
    multiply and add into one FMA there; the op itself does not). The
    routing, the order and the arithmetic of every site, free of the drift
    of the free-running comparison below."""
    _, _, net = tiny_pair
    want, meta, sites = jax_lane
    forced = iter(sites)
    refs = []

    def site(x):
        xj, kernel, bias = next(forced)
        assert tuple(x.shape) == xj.shape
        refs.append(np.asarray(jax_quant.ring_conv_w8a8(jnp.asarray(xj), kernel, bias, jnp.float32)))
        return torch.from_numpy(xj.copy())

    real = quant.ring_conv_w8a8
    got_sites = []

    def recorded(x, kernel, bias, out_dtype=None, packed=None, width=None):
        y = real(x, kernel, bias, out_dtype, packed, width=width)
        got_sites.append(y.numpy())
        return y

    monkeypatch.setattr(quant, "ring_conv_w8a8", recorded)
    got, _ = _port_lane_run(net, *_inputs(), monkeypatch, site=site)
    assert len(got_sites) == len(refs) == len(meta)
    for y, ref in zip(got_sites, refs):
        np.testing.assert_array_equal(y, ref)
    np.testing.assert_array_equal(got, refs[-1])
    assert np.abs(got - want).max() <= 4 * np.finfo(np.float32).eps * np.abs(want).max()


def test_tiny_forward_under_the_lane_matches_jax(tiny_pair, jax_lane, monkeypatch):
    """The port's own forward under the lane against JAX's (relative L2 <=
    FORWARD_REL_L2), and the lane against the fp32 network within JAX's
    gate (tests/test_quant.py:97-108)."""
    jnet, variables, net = tiny_pair
    x, cond = _inputs()
    want = jax_lane[0]
    got, _ = _port_lane_run(net, x, cond, monkeypatch)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= FORWARD_REL_L2, rel
    fp = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x), jnp.asarray(cond)))
    lane_err = np.linalg.norm(got - fp) / np.linalg.norm(fp)
    cos = float(got.ravel() @ fp.ravel() / (np.linalg.norm(got) * np.linalg.norm(fp)))
    assert 1e-3 < lane_err < 0.25 and cos > 0.97, (lane_err, cos)


def test_the_lane_is_inference_only(tiny_pair):
    _, _, net = tiny_pair
    x = torch.randn((1, 4, 8, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        quant.ring_conv_w8a8(x, torch.randn(3, 3, 8, 8), None)
    layers.set_quant_conv(net, "w8a8")
    try:
        with pytest.raises(RuntimeError, match="inference-only"):
            net(torch.zeros((1, 16, 64, 2)), torch.zeros((1,)))
        with torch.no_grad():
            assert torch.isfinite(net(torch.zeros((1, 16, 64, 2)), torch.zeros((1,)))).all()
    finally:
        layers.set_quant_conv(net, None)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        layers.set_quant_conv(net, "w4a4")


def test_int8_batches_chunk_as_the_jax_package():
    """One activation scale covers a chunk, so under the lane the port uses
    the JAX package's bounds: at 64x1024 a batch over 384 images runs in
    chunks of 256; off the lane its own 512."""
    model = build_model(port_config.Config(model=port_config.ModelConfig(
        base_channels=8, channel_multiplier=(1, 1, 1, 1), num_residual_blocks=(1, 1, 1, 1),
        gn_num_groups=4, attn_num_heads=2)), device="cpu")
    ddpm = DDPM(build_diffusion(port_config.Config(), model))
    hw = 64 * 1024
    assert quant.QMAX == 127
    assert (ddpm.INT8_MAX_BATCH_PIXELS, ddpm.INT8_BATCH_CHUNK_PIXELS) == (
        JaxDDPM.MAX_BATCH_PIXELS, JaxDDPM.BATCH_CHUNK_PIXELS)
    assert ddpm._batch_chunk(400, None, range(400)) == 400
    layers.set_quant_conv(model, "w8a8")
    assert ddpm._batch_chunk(384, None, range(384)) == 384
    assert ddpm._batch_chunk(400, None, range(400)) == JaxDDPM.BATCH_CHUNK_PIXELS // hw == 256


@pytest.fixture(scope="module")
def tiny_msgpack(tmp_path_factory):
    cfg = port_config.Config(
        data=port_config.DataConfig(dataset="synthetic", resolution=(16, 64), projection="spherical-256"),
        model=port_config.ModelConfig(base_channels=8, channel_multiplier=(1, 2, 2, 2),
                                      num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2),
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg, device="cpu")
        with torch.no_grad():
            for p in model.parameters():  # the zero-initialised convs too
                p.copy_(torch.randn(p.shape) * 0.1)
    model.coords.copy_(t(model_coords(cfg).transpose(2, 0, 1)[None]))
    variables = jax_from_state_dict(model.state_dict())
    path = tmp_path_factory.mktemp("ckpt") / "tiny.msgpack"
    write_checkpoint(str(path), port_config.asdict(cfg), variables, ema_weights=variables, step=1)
    return str(path)


def _count_lane(monkeypatch):
    calls = []
    real = quant.ring_conv_w8a8

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(layers, "ring_conv_w8a8", counted)
    return calls


def test_generate_int8_runs_the_lane(tiny_msgpack, tmp_path, monkeypatch, capsys):
    calls = _count_lane(monkeypatch)
    args = generate.parse_args(["--ckpt", tiny_msgpack, "--int8", "--mode", "ddim", "--batch_size", "2",
                                "--sampling_steps", "2", "--device", "cpu", "--out_dir", str(tmp_path)])
    assert generate.main(args) == 0
    assert len(calls) == 2 * (8 * 2 + 2 + 3)  # two forwards
    assert (tmp_path / "samples_img.png").exists() and (tmp_path / "samples_bev.png").exists()
    assert "int8" in capsys.readouterr().err


def test_sample_and_save_under_r2dm_tpu_int8_runs_the_lane(tiny_msgpack, tmp_path, monkeypatch):
    """The files hold the lane's samples: equal to DDPM.sample of the
    checkpoint with the lane set, and not to the fp32 samples."""
    calls = _count_lane(monkeypatch)
    monkeypatch.setenv("R2DM_TPU_INT8", "1")
    out = tmp_path / "int8"
    args = sample_and_save.parse_args(["--ckpt", tiny_msgpack, "--output_dir", str(out), "--num_samples", "3",
                                       "--batch_size", "3", "--num_steps", "2", "--mode", "ddim", "--device", "cpu"])
    assert sample_and_save.main(args) == 0
    assert len(calls) == 2 * (8 * 2 + 2 + 3)
    got = np.stack([np.load(out / f"samples_{i:010d}.npz")["sample"] for i in range(3)])
    ddpm, lidar, _ = setup_model(tiny_msgpack, device="cpu")
    fp = sample_and_save.postprocess(ddpm.sample(3, 2, seeds=[0, 1, 2], mode="ddim"), lidar).numpy()
    layers.set_quant_conv(ddpm.model, "w8a8")
    want = sample_and_save.postprocess(ddpm.sample(3, 2, seeds=[0, 1, 2], mode="ddim"), lidar).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - fp).max() > 0


def test_bench_reports_the_lane(monkeypatch):
    """Under R2DM_TPU_INT8 the bench's network runs the lane and its result
    says so; MFU stays against the bf16 peak, as the JAX bench.py:149-155."""
    monkeypatch.delenv("R2DM_TPU_INT8", raising=False)
    assert bench.int8_lane() is None
    monkeypatch.setenv("R2DM_TPU_INT8", "1")
    assert bench.int8_lane() == "w8a8"
    small = port_config.Config(data=port_config.DataConfig(resolution=(16, 64)), model=port_config.ModelConfig(
        base_channels=8, channel_multiplier=(1, 2, 2, 2), num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4,
        attn_num_heads=2))
    ddpm = bench.random_ddpm("cpu", cfg=small)
    assert layers.quant_conv_mode(ddpm.model) == "w8a8"
    monkeypatch.delenv("R2DM_TPU_INT8")
    assert layers.quant_conv_mode(bench.random_ddpm("cpu", cfg=small).model) is None
    assert bench.PEAK_BF16_FLOPS == 989e12
