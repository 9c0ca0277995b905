"""The port's width axis on the CPU: gloo ranks in subprocesses that split
each image's columns (``--mesh 1x2``, ``1x4`` and ``2x2``) against one
process with the same inputs and seeds, and against the JAX package's
forward, its loss and gradients and its int8 convolution; the backward of
every sharded op; the entry points under ``--mesh 1x2``, the int8 lane's
too; and the shard check's errors. The RefineNet's width axis is tested in
``test_torch_port_refinenet_width.py``.

The ranks of each mesh run once a module (``width_runs``) and write every
result to an npz file; the tests below read them. Each rank is a subprocess
of ``test_torch_port_parallel.Ranks`` (file rendezvous in the test's own
directory, a deadline a group, one intra-op thread). The network and its
inputs come from numpy seeds through ``SHARED``, code that the ranks and
this process run alike. The random weights are N(0, 0.05^2), the repo's
convention for a random network (``bench.random_ddpm``, the JAX package's
flow fixture): a free-running Gaussian chain's first step (t = 1, 1/alpha
= 1800, then clipped) amplifies fp32 rounding by that factor, and at this
scale the sharded chains agree with one rank to a few 1e-7.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_parallel import run, tiny_msgpack  # noqa: F401 (a fixture)

from r2dm_tpu.models.efficient_unet import EfficientUNet as JaxUNet
from r2dm_tpu_torch import bench, parallel
from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch.inference import build_model
from r2dm_tpu_torch.models import layers
from r2dm_tpu_torch.models.layers import set_quant_conv, set_width_shard
from r2dm_tpu_torch.utils.weights import jax_from_state_dict

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

# the network, its inputs and the chains, run alike by the ranks and by this
# process; a rank runs them on its columns (``world``), this process on the
# whole image (``world=None``)
SHARED = r'''
import numpy as np
import torch

from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch.inference import DDPM, build_diffusion
from r2dm_tpu_torch.models.efficient_unet import EfficientUNet
from r2dm_tpu_torch.models.layers import SelfAttention

KW = dict(in_channels=2, resolution=(16, 64), base_channels=8, channel_multiplier=(1, 2, 2, 2),
          num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2)


def arr(seed, *shape, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale)


def randomize(module, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32) * 0.05))
    return module.eval()


def tiny_net(w2c=False, coords="fourier_features"):
    return randomize(EfficientUNet(width_merge_l1=w2c, coords_encoding=coords, **KW), 7)


def attention():
    with torch.random.fork_rng(devices=[]):
        attn = SelfAttention(16, 2)
    return randomize(attn, 8)


def ddpm(timestep_type="continuous"):
    cfg = port_config.Config(data=port_config.DataConfig(resolution=(16, 64)))
    cfg.diffusion.timestep_type = timestep_type
    return DDPM(build_diffusion(cfg, tiny_net()), cfg)


# name -> (process, call): every chain of the serving surface, 3 steps at b2
CHAINS = {
    "ddpm": ("continuous", dict(mode="ddpm")),
    "ddim": ("continuous", dict(mode="ddim")),
    "ddim_eta": ("continuous", dict(mode="ddim", ddim_eta=0.5)),
    "dpmpp_2m": ("continuous", dict(mode="dpmpp_2m")),
    "ddim_return_all": ("continuous", dict(mode="ddim", return_all=True)),
    "ddpm_x_T_noise": ("continuous", dict(mode="ddpm", x_T=arr(30, 2, 16, 64, 2), noise=arr(31, 3, 2, 16, 64, 2))),
    "discrete_ddpm": ("discrete", dict(mode="ddpm")),
    "discrete_ddim": ("discrete", dict(mode="ddim", ddim_eta=0.3)),
    "flow_euler": ("flow", dict(mode="euler")),
    "flow_midpoint": ("flow", dict(mode="midpoint")),
}
REPAINTS = ("continuous", "flow")


def bench_ddpm():
    from r2dm_tpu_torch import bench

    return bench.random_ddpm("cpu", cfg=port_config.Config(
        data=port_config.DataConfig(resolution=(16, 64)),
        model=port_config.ModelConfig(base_channels=8, channel_multiplier=(1, 2, 2, 2),
                                      num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2)))


LOSS_KW = dict(KW, resolution=(16, 128))  # level 4 holds 16 columns: 4 a rank under 1x4


def loss_net(dropout=0.0):
    return randomize(EfficientUNet(dropout=dropout, **LOSS_KW), 9).train()


def loss_batch():
    """x_0, steps, noise and a loss mask of a b4 batch at 16x128."""
    steps = torch.from_numpy(np.random.default_rng(61).uniform(0, 1, 4).astype(np.float32))
    return arr(60, 4, 16, 128, 2), steps, arr(62, 4, 16, 128, 2), (arr(63, 4, 16, 128, 2) > -0.5).float()


def loss_of(net, x_0, steps, noise, mask, generator=None):
    from r2dm_tpu_torch.diffusion import ContinuousTimeGaussianDiffusion

    return ContinuousTimeGaussianDiffusion(net).p_loss(net, x_0, steps, noise, loss_mask=mask,
                                                       model_kwargs={"generator": generator})


def grad_ops():
    """name -> (the one-rank function, its sharded form given a world, the
    inputs, the W dim of each input or None for a parameter): every sharded
    op with a backward."""
    from r2dm_tpu_torch.ops import act_ringconv, fused_resample, gn_silu, resample

    x, k, bias = arr(2, 2, 4, 32, 8), arr(3, 3, 3, 8, 16, scale=0.3), arr(4, 16, scale=0.1)
    ops = {"conv": (lambda x, k, b: act_ringconv.act_ringconv_plain(x, None, None, k, b, apply_act=False),
                    lambda w: lambda x, k, b: act_ringconv.act_ringconv_sharded(x, k, b, w), [x, k, bias],
                    [2, None, None])}
    for aff in ((8,), (2, 8)):
        gain, shift = arr(7, *aff, scale=0.5) + 1.0, arr(8, *aff, scale=0.5)
        for silu in (False, True):
            ops[f"gn_{len(aff)}_{int(silu)}"] = (
                lambda x, g, s, silu=silu: gn_silu.fused_group_norm_silu_plain(x, g, s, 4, 1e-6, silu),
                lambda w, silu=silu: lambda x, g, s: gn_silu.group_norm_silu_sharded(x, g, s, 4, 1e-6, silu, w),
                [x + 0.2, gain, shift], [2, None, None])
    attn = attention()
    names = [n for n, _ in attn.named_parameters()]

    def attend(w):
        def fn(h, *params):
            attn.width_shard = w
            try:
                return torch.func.functional_call(attn, dict(zip(names, params)), (h,))
            finally:
                attn.width_shard = None
        return fn

    ops["attention"] = (attend(None), attend, [arr(9, 2, 4, 16, 16)] + [p.detach() for p in attn.parameters()],
                        [2] + [None] * len(names))
    xr, kd, bd = arr(11, 2, 8, 32, 4), arr(12, 3, 3, 4, 6, scale=0.3), arr(13, 6, scale=0.1)
    ops["upsample"] = (resample.upsample2x, lambda w: lambda x: resample.upsample2x(x, width=w), [xr], [2])
    ops["downsample"] = (resample.downsample2x, lambda w: lambda x: resample.downsample2x(x, width=w), [xr], [2])
    ops["conv_then_downsample"] = (
        fused_resample.conv_then_downsample,
        lambda w: lambda x, k, b: fused_resample.conv_then_downsample(x, k, b, width=w), [xr, kd, bd], [2, None, None])
    ops["upsample_then_conv"] = (
        fused_resample.upsample_then_conv,
        lambda w: lambda x, k, b: fused_resample.upsample_then_conv(x, k, b, width=w), [xr, kd, bd], [2, None, None])
    return ops


def op_grads(fn, inputs, world=None):
    """(y, the gradient of each input) of sum(fn(*inputs) * dy), dy drawn
    for the whole image and cut to the rank's columns under ``world``."""
    from r2dm_tpu_torch import parallel

    leaves = [t.clone().requires_grad_() for t in inputs]
    y = fn(*leaves)
    n = world.width_size if parallel.sharded(world) else 1
    y.backward(parallel.shard_columns(arr(99, *y.shape[:2], y.shape[2] * n, *y.shape[3:]), world))
    return y.detach(), [t.grad for t in leaves]


def lane_sites(dtype=None):
    """Each quantized site of the tiny network's forward on the int8 lane on
    one rank, in order: (x, kernel, bias, out dtype)."""
    from r2dm_tpu_torch.models import layers

    net = layers.set_quant_conv(randomize(EfficientUNet(dtype=dtype, **KW), 7), "w8a8")
    sites, real = [], layers.ring_conv_w8a8

    def recorded(x, kernel, bias, out_dtype=None, packed=None, width=None):
        sites.append((x, kernel.detach(), bias.detach(), out_dtype or x.dtype))
        return real(x, kernel, bias, out_dtype, packed, width=width)

    layers.ring_conv_w8a8 = recorded
    try:
        with torch.no_grad():
            net(arr(10, 2, 16, 64, 2), torch.tensor([0.3, -1.2]))
    finally:
        layers.ring_conv_w8a8 = real
    return sites


def chains(world, seeds=(5, 6)):
    out = {}
    for name, (kind, kw) in CHAINS.items():
        out[name] = ddpm(kind).sample(2, 3, seeds=list(seeds), world=world, **kw).numpy()
    known, mask = arr(32, 2, 2, 16, 64), (arr(33, 1, 2, 16, 64) > 0).float()
    for kind in REPAINTS:
        out[f"repaint_{kind}"] = ddpm(kind).repaint(known, mask, 3, 2, seeds=list(seeds), world=world).numpy()
    return out
'''

RANK = SHARED + r'''
import os

from r2dm_tpu_torch import bench, parallel
from r2dm_tpu_torch.models import layers
from r2dm_tpu_torch.ops import act_ringconv, gn_silu
from r2dm_tpu_torch.ops.pad import ring_pad

OUT, MESHES = __OUT__, __MESHES__
res = {}


def columns(world, t):
    return parallel.shard_columns(t, world)


def total(t, world):
    """The width shares of a gradient or loss summed, then the data mean."""
    t = t.detach().clone()
    torch.distributed.all_reduce(t)
    return t / world.data_size


for mesh in MESHES:
    world = parallel.init("cpu", mesh=mesh)
    tag = mesh.replace("x", "_")
    # halo_exchange + ring_pad: this rank's padded columns of the full ring_pad, bit for bit;
    # its adjoint: each rank's cotangent of its padded window, against autograd through the
    # whole image's ring_pad of every window
    x = arr(1, 2, 3, 64 if world.width_size < 4 else 32, 5)
    for pads in ((1, 1, 1, 1), (2, 3, 0, 0), (0, 2, 1, 0), (4, 4, 2, 2)):
        left, right = pads[:2]
        key = '_'.join(map(str, pads))
        got = ring_pad(columns(world, x), pads, width=world)
        full = ring_pad(x, pads)
        Wl = x.shape[2] // world.width_size
        want = full.narrow(2, world.width_rank * Wl, Wl + left + right)
        res[f"{tag}_ring_pad_{key}_exact"] = np.array(torch.equal(got, want))
        dys = [arr(20 + w, *got.shape) for w in range(world.width_size)]
        xf = x.clone().requires_grad_()
        padded = ring_pad(xf, pads)
        sum((padded.narrow(2, w * Wl, Wl + left + right) * dy).sum() for w, dy in enumerate(dys)).backward()
        xl = columns(world, x).requires_grad_()
        (ring_pad(xl, pads, width=world) * dys[world.width_rank]).sum().backward()
        res[f"{tag}_halo_adjoint_{key}_exact"] = np.array(torch.equal(xl.grad, columns(world, xf.grad)))
    # every sharded op's backward: dx gathered, parameter gradients summed over the width group
    if world.data_size == 1:
        for name, (_, sharded_fn, inputs, dims) in grad_ops().items():
            y, grads = op_grads(sharded_fn(world), [columns(world, t) if d is not None else t
                                                    for t, d in zip(inputs, dims)], world)
            res[f"{tag}_op_{name}_y"] = parallel.gather_columns(y, world).numpy()
            for i, (g, d) in enumerate(zip(grads, dims)):
                g = parallel.gather_columns(g, world, d) if d is not None else parallel.all_reduce_sum_(g, world)
                res[f"{tag}_op_{name}_d{i}"] = g.numpy()
    # the tiny network's loss and every parameter gradient: this data group's rows, the
    # rank's columns; the width shares summed, the data mean taken (the trainer's reduction)
    D, d = world.data_size, world.data_index
    x_0, steps, noise, mask = loss_batch()
    rows = slice(d * 4 // D, (d + 1) * 4 // D)
    for drop in ((0.0, 0.2) if D == 1 else (0.0,)):
        net = layers.set_width_shard(loss_net(drop), world)
        g = torch.Generator().manual_seed(3)
        loss = loss_of(net, columns(world, x_0[rows]), steps[rows], columns(world, noise[rows]),
                       columns(world, mask[rows]), g)
        loss.backward()
        res[f"{tag}_loss_drop{drop}"] = total(loss, world).numpy()
        for name, p in net.named_parameters():
            res[f"{tag}_grad_drop{drop}_{name}"] = total(p.grad, world).numpy()
    # the int8 lane: each site of the tiny network (fp32 and bf16 networks) fed this rank's
    # columns of its one-rank input; the s8 layout, the absmax and the output against one rank
    from r2dm_tpu_torch.ops import quant

    for net_dtype in (None, torch.bfloat16):
        for i, (x, k, b, out_dtype) in enumerate(lane_sites(net_dtype)):
            site = f"{tag}_int8_{'bf16' if net_dtype else 'fp32'}_{i}"
            xs = columns(world, x)
            amax = quant.act_absmax(xs, world)
            xq = quant.act_quantize(xs, amax, halo=parallel.halo_exchange(xs, 1, 1, world))
            Wl = xs.shape[2]
            one_amax = quant.act_absmax(x)
            one_xq = quant.act_quantize_plain(x, one_amax).narrow(2, world.width_rank * Wl, Wl + 2)
            res[f"{site}_layout_exact"] = np.array(torch.equal(xq, one_xq) and torch.equal(amax, one_amax))
            y = quant.ring_conv_w8a8(xs, k, b, out_dtype, width=world)
            res[f"{site}_y"] = parallel.gather_columns(y, world).float().numpy()
    # a NaN in one rank's columns: every rank's output all NaN
    x, k, b, _ = lane_sites()[1]
    x = x.clone()
    x[0, 1, x.shape[2] - 2] = float("nan")  # the last width rank's columns
    y = quant.ring_conv_w8a8(columns(world, x), k, b, width=world)
    res[f"{tag}_int8_nan_all"] = np.array(bool(torch.isnan(y).all()))
    if world.data_size == 1:
        # the halo'd conv (plain path), the split GroupNorm, gathered-K/V attention
        x, k, bias = arr(2, 2, 4, 32, 8), arr(3, 3, 3, 8, 16, scale=0.3), arr(4, 16, scale=0.1)
        a, b = arr(5, 2, 8, scale=0.5) + 1.0, arr(6, 2, 8, scale=0.2)
        xs = columns(world, x)
        for act in (False, True):
            y = act_ringconv.fused_act_ringconv(xs, a, b, k, bias, apply_act=act,
                                                halo=parallel.halo_exchange(xs, 1, 1, world))
            res[f"{tag}_conv_act{int(act)}"] = parallel.gather_columns(y, world).numpy()
        for aff in ((8,), (2, 8)):
            gain, shift = arr(7, *aff, scale=0.5) + 1.0, arr(8, *aff, scale=0.5)
            for silu in (False, True):
                y = gn_silu.group_norm_silu_sharded(xs, gain, shift, 4, 1e-6, silu, world)
                res[f"{tag}_gn_{len(aff)}_{int(silu)}"] = parallel.gather_columns(y, world).numpy()
        attn = attention()
        attn.width_shard = world
        h = arr(9, 2, 4, 16, 16)
        with torch.no_grad():
            res[f"{tag}_attention"] = parallel.gather_columns(attn(columns(world, h)), world).numpy()
    if world.width_size != 2:  # the tiny network's level 4 has 8 columns: 2 ranks, not 4
        continue
    # the tiny network: this data group's rows of a b4 batch, its columns
    rows = slice(2 * world.data_index, 2 * world.data_index + 2) if world.data_size == 2 else slice(0, 4)
    x, cond = arr(10, 4, 16, 64, 2), torch.tensor([0.3, -1.2, 2.0, 0.0])
    for w2c in (False, True):
        net = layers.set_width_shard(tiny_net(w2c=w2c), world)
        with torch.no_grad():
            y = parallel.gather_columns(net(columns(world, x[rows]), cond[rows]), world)
        parts = parallel.gather_objects(world, y.numpy())
        if parts is not None:
            res[f"{tag}_net_w2c{int(w2c)}"] = np.concatenate(parts[::world.width_size])
    # the tiny network on the int8 lane
    net = layers.set_width_shard(layers.set_quant_conv(tiny_net(), "w8a8"), world)
    with torch.no_grad():
        res[f"{tag}_net_int8"] = parallel.gather_columns(net(columns(world, x[rows]), cond[rows]), world).numpy()
    out = chains(world, seeds=(5 + 2 * world.data_index, 6 + 2 * world.data_index))
    parts = parallel.gather_objects(world, out)
    if parts is not None:
        for name in out:
            res[f"{tag}_chain_{name}"] = np.stack([p[name] for p in parts[::world.width_size]])
    res[f"{tag}_collectives"] = np.array(world.collective_calls)
    # the bench's chain, on the data axis and the width axis, on both lanes
    res[f"{tag}_bench_chain"] = bench.chain(bench_ddpm(), 2, 2, "ddpm", 3, world).numpy()
    os.environ["R2DM_TPU_INT8"] = "1"
    res[f"{tag}_bench_chain_int8"] = bench.chain(bench_ddpm(), 2, 2, "ddpm", 3, world).numpy()
    del os.environ["R2DM_TPU_INT8"]
    res[f"{tag}_layout"] = np.array([world.rank, world.data_index, world.width_rank, world.data_size,
                                     world.width_size])
np.savez(f"{OUT}/rank{torch.distributed.get_rank()}.npz", **res)
'''


def shared():
    ns = {}
    exec(SHARED, ns)
    return ns


@pytest.fixture(scope="module")
def width_runs(tmp_path_factory):
    """{mesh group: [every rank's npz dict]}: two ranks (``1x2``) and four
    (``1x4`` for the halos, then ``2x2``)."""
    out = {}
    for name, meshes, n in (("two", ["1x2"], 2), ("four", ["1x4", "2x2"], 4)):
        d = tmp_path_factory.mktemp(f"width-{name}")
        code = RANK.replace("__OUT__", repr(str(d))).replace("__MESHES__", repr(meshes))
        run(d, "-c", [[code]] * n)
        out[name] = [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]
    return out


@pytest.fixture(scope="module")
def one_rank():
    """What one process computes from the same inputs and seeds."""
    return shared()


# ------------------------------------------------------------- halos
@pytest.mark.parametrize("group,mesh", [("two", "1_2"), ("four", "1_4"), ("four", "2_2")])
def test_halo_exchange_ring_pad_equals_the_full_ring_pad(width_runs, group, mesh):
    """Each rank's ring_pad under the width axis is its columns of the whole
    ring_pad, margins from the neighbours (the ring wrapping across ranks),
    bit for bit, for margins up to 4 columns."""
    for r, res in enumerate(width_runs[group]):
        exact = {k: bool(v) for k, v in res.items() if k.startswith(f"{mesh}_ring_pad")}
        assert len(exact) == 4 and all(exact.values()), (r, exact)


def test_the_rank_layout_is_the_jax_mesh_reshape(width_runs):
    """Rank d*W + w: width groups of consecutive ranks (r2dm_tpu/parallel/mesh.py:42-43)."""
    got = [res["2_2_layout"].tolist() for res in width_runs["four"]]
    assert got == [[0, 0, 0, 2, 2], [1, 0, 1, 2, 2], [2, 1, 0, 2, 2], [3, 1, 1, 2, 2]]
    assert [res["1_2_layout"].tolist() for res in width_runs["two"]] == [[0, 0, 0, 1, 2], [1, 0, 1, 1, 2]]


# ------------------------------------------------------ sharded ops
TOL = dict(rtol=1e-5, atol=1e-5)  # fp32, sums in another order


@pytest.mark.parametrize("act", [0, 1])
def test_halo_conv_plain_path_sharded_equals_unsharded(width_runs, one_rank, act):
    from r2dm_tpu_torch.ops import act_ringconv

    arr = one_rank["arr"]
    x, k, bias = arr(2, 2, 4, 32, 8), arr(3, 3, 3, 8, 16, scale=0.3), arr(4, 16, scale=0.1)
    a, b = arr(5, 2, 8, scale=0.5) + 1.0, arr(6, 2, 8, scale=0.2)
    want = act_ringconv.act_ringconv_plain(x, a, b, k, bias, apply_act=bool(act)).numpy()
    np.testing.assert_allclose(width_runs["two"][0][f"1_2_conv_act{act}"], want, **TOL)


@pytest.mark.parametrize("affine", [1, 2])
@pytest.mark.parametrize("silu", [0, 1])
def test_split_group_norm_sharded_equals_unsharded(width_runs, one_rank, affine, silu):
    """Stats of each rank's columns, summed over the width group, then the
    apply with the whole image's count: the one-rank GroupNorm."""
    from r2dm_tpu_torch.ops import gn_silu

    arr = one_rank["arr"]
    aff = (8,) if affine == 1 else (2, 8)
    gain, shift = arr(7, *aff, scale=0.5) + 1.0, arr(8, *aff, scale=0.5)
    want = gn_silu.fused_group_norm_silu_plain(arr(2, 2, 4, 32, 8), gain, shift, 4, 1e-6, bool(silu)).numpy()
    for res in width_runs["two"]:
        np.testing.assert_allclose(res[f"1_2_gn_{affine}_{silu}"], want, **TOL)


def test_gathered_kv_attention_equals_unsharded(width_runs, one_rank):
    with torch.no_grad():
        want = one_rank["attention"]()(one_rank["arr"](9, 2, 4, 16, 16)).numpy()
    np.testing.assert_allclose(width_runs["two"][1]["1_2_attention"], want, **TOL)


# --------------------------------------------------------- the network
def _jax_forward(net, x, cond, w2c):
    variables = jax_from_state_dict(net.state_dict())
    jnet = JaxUNet(width_merge_l1=w2c, coords_encoding="fourier_features", **shared()["KW"])
    return np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x), jnp.asarray(cond)))


@pytest.mark.parametrize("mesh", ["1_2", "2_2"])
@pytest.mark.parametrize("w2c", [0, 1])
def test_sharded_network_matches_the_jax_forward(width_runs, one_rank, mesh, w2c):
    """A tiny EfficientUNet's forward under 1x2 and 2x2 (the b4 batch split
    over the data axis there), W2C too, gathered, against the JAX package's
    forward from the same parameters and inputs (tests/test_unet_parity.py's
    tolerance) and against the port's own unsharded forward (fp32 order)."""
    x, cond = one_rank["arr"](10, 4, 16, 64, 2), np.array([0.3, -1.2, 2.0, 0.0], np.float32)
    net = one_rank["tiny_net"](w2c=bool(w2c))
    got = width_runs["two" if mesh == "1_2" else "four"][0][f"{mesh}_net_w2c{w2c}"]
    want = _jax_forward(net, x.numpy(), cond, bool(w2c))
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    with torch.no_grad():
        np.testing.assert_allclose(got, net(x, torch.from_numpy(cond)).numpy(), **TOL)


# ------------------------------------------------------------ backward
ALL_MESHES = [("two", "1_2"), ("four", "1_4"), ("four", "2_2")]


@pytest.mark.parametrize("group,mesh", ALL_MESHES)
def test_the_halo_exchange_adjoint_is_autograd_of_the_whole_ring_pad(width_runs, group, mesh):
    """Each rank's gradient of its columns through ring_pad(width=), for
    its cotangent of its padded window, equals autograd through the whole
    image's ring_pad of every rank's window, cut to the rank's columns, bit
    for bit (margins up to 4 columns; under 1x2 both neighbours are one
    rank)."""
    for r, res in enumerate(width_runs[group]):
        exact = {k: bool(v) for k, v in res.items() if k.startswith(f"{mesh}_halo_adjoint")}
        assert len(exact) == 4 and all(exact.values()), (r, exact)


GRAD_OPS = list(shared()["grad_ops"]())


@pytest.mark.parametrize("group,mesh", [("two", "1_2"), ("four", "1_4")])
@pytest.mark.parametrize("op", GRAD_OPS)
def test_a_sharded_op_backward_equals_one_ranks(width_runs, one_rank, group, mesh, op):
    """The halo'd conv (its autograd function), the split GroupNorm and
    AdaGN with and without SiLU, gathered-K/V attention, the FIR resamples,
    the composed down conv and the polyphase up conv under ``width=``: dx
    gathered over the width group and every parameter gradient summed over
    it, against the op on one process, max|err| <= 1e-5 max|ref|."""
    fn, _, inputs, _ = one_rank["grad_ops"]()[op]
    y, grads = one_rank["op_grads"](fn, inputs)
    for r, res in enumerate(width_runs[group]):
        for name, got, want in [("y", res[f"{mesh}_op_{op}_y"], y)] + [
                (f"d{i}", res[f"{mesh}_op_{op}_d{i}"], g) for i, g in enumerate(grads)]:
            want = want.numpy()
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (r, name)


@pytest.fixture(scope="module")
def one_rank_loss(one_rank):
    """{dropout: (loss, {name: gradient})} of the b4 batch on one process."""
    out = {}
    for drop in (0.0, 0.2):
        net = one_rank["loss_net"](drop)
        loss = one_rank["loss_of"](net, *one_rank["loss_batch"](), torch.Generator().manual_seed(3))
        loss.backward()
        out[drop] = (loss.item(), {n: p.grad.numpy() for n, p in net.named_parameters()})
    return out


@pytest.fixture(scope="module")
def jax_loss(one_rank):
    """(loss, {name: gradient}) of the JAX package's p_loss of the same
    network and batch, ``jax.value_and_grad`` under make_mesh((1, 2)): the
    batch's W split over the width axis by GSPMD."""
    from r2dm_tpu.diffusion import ContinuousTimeGaussianDiffusion as JaxContinuous
    from r2dm_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
    from r2dm_tpu_torch.utils.weights import state_dict_from_jax

    net = one_rank["loss_net"]()
    variables = jax_from_state_dict(net.state_dict())
    jnet = JaxUNet(coords_encoding="fourier_features", **one_rank["LOSS_KW"])
    ddpm = JaxContinuous(model=jnet)
    mesh = make_mesh((1, 2))
    x_0, steps, noise, mask = (np.asarray(t) for t in one_rank["loss_batch"]())

    def loss(params, x_0, steps, noise, mask):
        return ddpm.p_loss({"params": params, "buffers": variables["buffers"]}, x_0, steps, noise=noise,
                           loss_mask=mask)

    rep, bat = replicated(mesh), batch_sharding(mesh)
    fn = jax.jit(jax.value_and_grad(loss), in_shardings=(rep, bat, rep, bat, bat))
    value, grads = fn(variables["params"], x_0, steps, noise, mask)
    grads = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads), "buffers": variables["buffers"]})
    return float(value), {n: grads[n].numpy() for n, _ in net.named_parameters()}


@pytest.mark.parametrize("group,mesh", ALL_MESHES)
def test_the_sharded_loss_and_gradients_match_one_rank_and_jax(width_runs, one_rank_loss, jax_loss, group, mesh):
    """The tiny network's masked min-SNR loss and every parameter gradient
    under 1x2, 1x4 and 2x2 (each rank its columns' share; the shares summed
    over the world and divided by the data size, as the trainer does),
    against one process and against ``jax.value_and_grad`` under
    make_mesh((1, 2)): the tolerances of
    test_torch_port_training.py::test_p_loss_and_gradients_match_jax (rtol
    1e-4; atol 2e-5, for a gradient times the largest entry of any)."""
    for ref_loss, ref_grads in (one_rank_loss[0.0], jax_loss):
        scale = max(1.0, max(float(np.abs(g).max()) for g in ref_grads.values()))
        for r, res in enumerate(width_runs[group]):
            np.testing.assert_allclose(res[f"{mesh}_loss_drop0.0"], ref_loss, rtol=1e-4, atol=2e-5)
            for name, want in ref_grads.items():
                np.testing.assert_allclose(res[f"{mesh}_grad_drop0.0_{name}"], want, rtol=1e-4, atol=2e-5 * scale,
                                           err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("group,mesh", [("two", "1_2"), ("four", "1_4")])
def test_dropout_under_a_width_axis_is_one_ranks(width_runs, one_rank_loss, group, mesh):
    """With dropout 0.2 each mask is drawn for the whole image from the
    step's generator and cut to the rank's columns: the loss and gradients
    of one process with the same generator."""
    ref_loss, ref_grads = one_rank_loss[0.2]
    scale = max(1.0, max(float(np.abs(g).max()) for g in ref_grads.values()))
    res = width_runs[group][0]
    np.testing.assert_allclose(res[f"{mesh}_loss_drop0.2"], ref_loss, rtol=1e-4, atol=2e-5)
    for name, want in ref_grads.items():
        np.testing.assert_allclose(res[f"{mesh}_grad_drop0.2_{name}"], want, rtol=1e-4, atol=2e-5 * scale,
                                   err_msg=name)


# ------------------------------------------------------- the int8 lane
@pytest.fixture(scope="module")
def one_rank_sites(one_rank):
    """{net dtype tag: [(one rank's output of the site, JAX's on the whole
    image)]} for every quantized site of the tiny fp32 and bf16 networks."""
    from r2dm_tpu.ops import quant as jax_quant
    from r2dm_tpu_torch.ops import quant

    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    out = {}
    for tag, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        out[tag] = []
        for x, k, b, out_dtype in one_rank["lane_sites"](dtype):
            want = quant.ring_conv_w8a8(x, k, b, out_dtype).float().numpy()
            xj = jnp.asarray(x.float().numpy()).astype(jdtype[x.dtype])
            ref = jax_quant.ring_conv_w8a8(xj, jnp.asarray(k.numpy()), jnp.asarray(b.numpy()), jdtype[out_dtype])
            out[tag].append((want, np.asarray(ref.astype(jnp.float32))))
    return out


@pytest.mark.parametrize("group,mesh", ALL_MESHES)
def test_every_int8_site_under_a_width_axis_is_one_ranks_bit_for_bit(width_runs, one_rank_sites, group, mesh):
    """Each quantized site of the tiny network (fp32 and bf16 networks), fed
    the rank's columns of its one-rank input: the absmax over the width
    group and the halo'd quantize pass give the rank's window of one rank's
    s8 layout, and the output gathered is one rank's and the JAX package's
    ``ring_conv_w8a8`` on the whole image, bit for bit."""
    for tag, sites in one_rank_sites.items():
        assert len(sites) == 21
        for i, (want, ref) in enumerate(sites):
            np.testing.assert_array_equal(want, ref)
            for r, res in enumerate(width_runs[group]):
                site = f"{mesh}_int8_{tag}_{i}"
                assert bool(res[f"{site}_layout_exact"]), (r, site)
                np.testing.assert_array_equal(res[f"{site}_y"], want, err_msg=f"rank {r} {site}")


@pytest.mark.parametrize("group,mesh", ALL_MESHES)
def test_a_nan_in_one_ranks_columns_makes_every_ranks_int8_output_nan(width_runs, group, mesh):
    """The absmax is reduced on |x|'s bits as int32, a NaN as the quiet NaN
    above +inf: one rank's NaN reaches every rank's scale, as one rank's
    NaN does on one rank."""
    assert [bool(res[f"{mesh}_int8_nan_all"]) for res in width_runs[group]] == [True] * len(width_runs[group])


@pytest.mark.parametrize("mesh", ["1_2", "2_2"])
def test_the_int8_network_under_a_width_axis_is_one_ranks(width_runs, one_rank, mesh):
    """The tiny network's forward on the int8 lane under 1x2 and 2x2,
    gathered, within 1e-2 relative L2 of one rank's (phase 16's forward
    gate; the sites are bit for bit, GroupNorm sums in another order)."""
    x, cond = one_rank["arr"](10, 4, 16, 64, 2), torch.tensor([0.3, -1.2, 2.0, 0.0])
    rows = slice(0, 4 if mesh == "1_2" else 2)  # rank 0's data group's rows: one activation scale a tensor
    net = set_quant_conv(one_rank["tiny_net"](), "w8a8")
    with torch.no_grad():
        want = net(x[rows], cond[rows]).numpy()
    got = width_runs["two" if mesh == "1_2" else "four"][0][f"{mesh}_net_int8"]
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


# ------------------------------------------------------------- chains
@pytest.fixture(scope="module")
def one_rank_chains(one_rank):
    return {seeds: one_rank["chains"](None, seeds=seeds) for seeds in ((5, 6), (7, 8))}


CHAIN_NAMES = list(shared()["CHAINS"]) + [f"repaint_{k}" for k in shared()["REPAINTS"]]


@pytest.mark.parametrize("name", CHAIN_NAMES)
def test_sharded_chain_equals_one_rank(width_runs, one_rank_chains, name):
    """DDPM.sample / repaint(world=) under 1x2, and under 2x2 with each data
    group on its own seeds: the same samples as one process with the same
    seeds (each draw the whole image's, the rank keeping its columns), to
    JAX's own mesh-parity tolerance (tests/test_inference.py:254)."""
    got = width_runs["two"][0][f"1_2_chain_{name}"][0]
    want = one_rank_chains[(5, 6)][name]
    assert np.isfinite(want).all() and want.std() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    both = width_runs["four"][0][f"2_2_chain_{name}"]
    np.testing.assert_allclose(both[0], want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(both[1], one_rank_chains[(7, 8)][name], rtol=0, atol=1e-4)


def test_a_sharded_chain_runs_the_collectives(width_runs):
    """Every width rank ran the halo exchanges, the GroupNorm sums and the
    key/value gathers (no quiet unsharded path)."""
    calls = [int(res["1_2_collectives"]) for res in width_runs["two"]]
    assert calls[0] == calls[1] > 1000


# -------------------------------------------------------- entry points
def test_sample_and_save_1x2_writes_one_ranks_files(tmp_path, tiny_msgpack):  # noqa: F811
    """sample_and_save --mesh 1x2 on two ranks: the files one process
    writes (width rank 0 writes them), each sample within 1e-4 m."""

    def argv(out, mesh):
        return ["--ckpt", tiny_msgpack, "--output_dir", str(out), "--batch_size", "3", "--num_samples", "5",
                "--num_steps", "2", "--mode", "ddim", "--device", "cpu", "--mesh", mesh]

    run(tmp_path, "r2dm_tpu_torch.sample_and_save", [argv(tmp_path / "one", "1")])
    outs = run(tmp_path, "r2dm_tpu_torch.sample_and_save", [argv(tmp_path / "two", "1x2")] * 2)
    assert "[5/5] saved" in outs[0] and "saved" not in outs[1]
    names = sorted(p.name for p in (tmp_path / "one").iterdir())
    assert names == [f"samples_{i:010d}.npz" for i in range(5)]
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == names
    for n in names:
        a, b = (np.load(tmp_path / d / n)["sample"] for d in ("one", "two"))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=n)


def test_int8_sample_and_save_1x2_writes_one_ranks_files(tmp_path, tiny_msgpack):  # noqa: F811
    """sample_and_save --mesh 1x2 under $R2DM_TPU_INT8: the int8 lane's
    files of one process, each sample within 1e-4 m."""

    def argv(out, mesh):
        return ["--ckpt", tiny_msgpack, "--output_dir", str(out), "--batch_size", "3", "--num_samples", "3",
                "--num_steps", "2", "--mode", "ddim", "--device", "cpu", "--mesh", mesh]

    env = {"R2DM_TPU_INT8": "1"}
    run(tmp_path, "r2dm_tpu_torch.sample_and_save", [argv(tmp_path / "one", "1")], env=env)
    run(tmp_path, "r2dm_tpu_torch.sample_and_save", [argv(tmp_path / "two", "1x2")] * 2, env=env)
    names = sorted(p.name for p in (tmp_path / "one").iterdir())
    assert names == [f"samples_{i:010d}.npz" for i in range(3)]
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == names
    for n in names:
        a, b = (np.load(tmp_path / d / n)["sample"] for d in ("one", "two"))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=n)


def test_evaluate_1x2_writes_one_ranks_json(tmp_path, tiny_msgpack):  # noqa: F811
    """evaluate --mesh 1x2: the extraction split over the data axis only
    (both width ranks extract every batch), one JSON equal to one
    process's, one real-set cache."""
    samples = tmp_path / "samples"
    run(tmp_path, "r2dm_tpu_torch.sample_and_save", [["--ckpt", tiny_msgpack, "--output_dir", str(samples),
                                                     "--num_samples", "3", "--num_steps", "2", "--device", "cpu"]])
    prelude = "from r2dm_tpu_torch.metrics.extractor import rangenet as rn\nrn.NUM_FEATURES = 256\n"
    argv = ["--ckpt", tiny_msgpack, "--sample_dir", str(samples), "--batch_size", "2", "--allow_random_extractors",
            "--device", "cpu"]
    env = {"R2DM_SYNTH_SCANS": "3"}
    cwds = [tmp_path / d for d in ("one", "two0", "two1")]
    for d in cwds:
        d.mkdir()
    results = []
    for ranks, mesh in (([0], "1"), ([1, 2], "1x2")):
        run(tmp_path, "r2dm_tpu_torch.evaluate", [argv + ["--mesh", mesh]] * len(ranks), prelude=prelude, env=env,
            cwds=[cwds[i] for i in ranks])
        [path] = sorted(tmp_path.glob("samples_*.json"))
        results.append(json.loads(path.read_text()))
        path.unlink()
    assert [len(list(d.glob("real_set_torch_*.npz"))) for d in cwds] == [1, 1, 0]
    one, two = results
    assert one["info"] == two["info"] and (one["info"]["#real"], one["info"]["#fake"]) == (3, 3)
    for section in ("img", "pts", "bev"):
        assert sorted(one[section]) == sorted(two[section])
        for k, v in one[section].items():
            assert np.isfinite(v) and two[section][k] == pytest.approx(v, rel=1e-6, abs=1e-12), (section, k)


def test_completion_demo_1x2_writes_one_figure(tmp_path, tiny_msgpack):  # noqa: F811
    """completion_demo --mesh 1x2: both ranks complete the four rows, each
    its columns; rank 0 alone writes the figure, of one process's size."""
    def read_png_size(path):  # (width, height) from the IHDR chunk
        head = path.read_bytes()[:24]
        assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
        return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")

    argv = ["--ckpt", tiny_msgpack, "--num_steps", "2", "--num_resample_steps", "2", "--device", "cpu"]
    cwds = [tmp_path / d for d in ("one", "two0", "two1")]
    for d in cwds:
        d.mkdir()
    env = {"R2DM_SYNTH_SCANS": "3"}
    run(tmp_path, "r2dm_tpu_torch.completion_demo", [argv], env=env, cwds=cwds[:1])
    run(tmp_path, "r2dm_tpu_torch.completion_demo", [argv + ["--mesh", "1x2"]] * 2, env=env, cwds=cwds[1:])
    name = "completion_T-0002_r-0002_j-0001.png"
    assert read_png_size(cwds[1] / name) == read_png_size(cwds[0] / name)
    assert not list(cwds[2].iterdir())


# ------------------------------------------------------------- errors
def _world(width: int) -> parallel.World:
    """A rank of a (1, width) mesh with no group: enough for the checks
    that run before any collective."""
    return parallel.World(rank=0, size=width, width_size=width)


def _tiny_cfg(resolution=(16, 64)):
    return port_config.Config(
        data=port_config.DataConfig(dataset="synthetic", resolution=resolution, projection="spherical-256"),
        model=port_config.ModelConfig(base_channels=8, channel_multiplier=(1, 2, 2, 2),
                                      num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2),
    )


@pytest.mark.parametrize("resolution,width", [((16, 64), 4), ((16, 64), 3), ((16, 72), 2)])
def test_a_width_that_does_not_split_the_narrowest_level_raises(resolution, width):
    """W/8 must divide by the width axis with at least 3 columns a rank (the
    composed down conv reads x[2o-2 .. 2o+3])."""
    net = build_model(_tiny_cfg(resolution=resolution), device="cpu")
    with pytest.raises(ValueError, match="level 4"):
        set_width_shard(net, _world(width))
    assert layers.width_shard_of(net) is None
    set_width_shard(net, _world(1))  # a width of one is the whole image
    assert layers.width_shard_of(net) is None


@pytest.mark.parametrize("spec,world,shape", [("1x2", 2, (1, 2)), ("2x2", 4, (2, 2)), ("1x4", 4, (1, 4))])
def test_parse_mesh_takes_a_width_axis(spec, world, shape):
    assert parallel.parse_mesh(spec, world) == shape


@pytest.mark.parametrize("group,mesh", [("two", "1_2"), ("four", "2_2")])
def test_the_bench_chain_runs_in_a_group_and_equals_one_rank(width_runs, one_rank, group, mesh):
    """bench's chain draws from per-image seeds: it runs on every rank of a
    group (DDPM's internal stream is refused there) and under the width axis
    gives one process's samples."""
    want = bench.chain(one_rank["bench_ddpm"](), 2, 2, "ddpm", 3).numpy()
    for res in width_runs[group]:
        np.testing.assert_allclose(res[f"{mesh}_bench_chain"], want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("group,mesh", [("two", "1_2"), ("four", "2_2")])
def test_the_int8_bench_chain_under_a_width_axis_equals_one_rank(width_runs, one_rank, group, mesh, monkeypatch):
    """bench's chain under $R2DM_TPU_INT8 on the width axis runs on every
    rank and gives one process's int8 samples but for the pixels the first
    step's clip flips. Each site is one rank's bit for bit, but GroupNorm
    sums in another order, so a site's input can cross a quantization step,
    and the t = 1 step (x_0 = (x - sigma eps) / alpha, 1/alpha = 1800,
    clipped to [-1, 1]) turns such a difference into a flip between -1 and
    1: at most 1 % of the pixels may move by more than 0.1 (0.1 % measured
    here), the rest by at most 2 % of the samples' largest value."""
    monkeypatch.setenv("R2DM_TPU_INT8", "1")
    want = bench.chain(one_rank["bench_ddpm"](), 2, 2, "ddpm", 3).numpy()
    assert np.isfinite(want).all() and want.std() > 0.1
    for res in width_runs[group]:
        diff = np.abs(res[f"{mesh}_bench_chain_int8"] - want)
        assert (diff > 0.1).mean() <= 1e-2
        assert np.median(diff) <= 2e-2 * np.abs(want).max()


def test_bench_counts_each_data_groups_images_once():
    """Under 2x2 the aggregate is the two data groups' img/s (each group's
    width rank 0), every rank's beside it."""
    rs = [{"value": v, "mfu": 0.1, "mfu_all": 0.1, "ddim32_img_per_s": 2 * v} for v in (1.0, 1.0, 3.0, 3.0)]
    out = bench.aggregate(rs, width_size=2)
    assert out["value"] == 4.0 and out["per_rank_img_per_s"] == [1.0, 1.0, 3.0, 3.0]
    assert out["ddim32_img_per_s"] == 8.0 and out["ranks"] == 4
