"""The port's width axis on the CPU: gloo ranks in subprocesses that split
each image's columns (``--mesh 1x2``, ``1x4`` and ``2x2``) against one
process with the same inputs and seeds, and against the JAX package's
forward; the entry points under ``--mesh 1x2``; and the errors of what does
not run under a width axis yet.

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
from r2dm_tpu_torch import bench, parallel
from r2dm_tpu_torch.models import layers
from r2dm_tpu_torch.ops import act_ringconv, gn_silu
from r2dm_tpu_torch.ops.pad import ring_pad

OUT, MESHES = __OUT__, __MESHES__
res = {}


def columns(world, t):
    return parallel.shard_columns(t, world)


for mesh in MESHES:
    world = parallel.init("cpu", mesh=mesh)
    tag = mesh.replace("x", "_")
    # halo_exchange + ring_pad: this rank's padded columns of the full ring_pad, bit for bit
    x = arr(1, 2, 3, 64 if world.width_size < 4 else 32, 5)
    for pads in ((1, 1, 1, 1), (2, 3, 0, 0), (0, 2, 1, 0), (4, 4, 2, 2)):
        left, right = pads[:2]
        got = ring_pad(columns(world, x), pads, width=world)
        full = ring_pad(x, pads)
        Wl = x.shape[2] // world.width_size
        want = full.narrow(2, world.width_rank * Wl, Wl + left + right)
        res[f"{tag}_ring_pad_{'_'.join(map(str, pads))}_exact"] = np.array(torch.equal(got, want))
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
    out = chains(world, seeds=(5 + 2 * world.data_index, 6 + 2 * world.data_index))
    parts = parallel.gather_objects(world, out)
    if parts is not None:
        for name in out:
            res[f"{tag}_chain_{name}"] = np.stack([p[name] for p in parts[::world.width_size]])
    res[f"{tag}_collectives"] = np.array(world.collective_calls)
    # the bench's chain, on the data axis and the width axis
    res[f"{tag}_bench_chain"] = bench.chain(bench_ddpm(), 2, 2, "ddpm", 3, world).numpy()
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


# ----------------------------------------------- what does not run yet
def _world(width: int) -> parallel.World:
    """A rank of a (1, width) mesh with no group: enough for the checks
    that run before any collective."""
    return parallel.World(rank=0, size=width, width_size=width)


def _tiny_cfg(architecture="efficient_unet", resolution=(16, 64)):
    return port_config.Config(
        data=port_config.DataConfig(dataset="synthetic", resolution=resolution, projection="spherical-256"),
        model=port_config.ModelConfig(architecture=architecture, base_channels=8, channel_multiplier=(1, 2, 2, 2),
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


def test_refinenet_under_a_width_axis_raises():
    from r2dm_tpu_torch.inference import DDPM, build_diffusion

    cfg = _tiny_cfg("refinenet")
    net = build_model(cfg, device="cpu")
    match = r"ROADMAP.md queue 1, parallelism \(width axis\): RefineNet"
    with pytest.raises(ValueError, match=match):
        set_width_shard(net, _world(2))
    with pytest.raises(ValueError, match=match):
        DDPM(build_diffusion(cfg, net), cfg).sample(1, 1, seeds=[0], world=_world(2))


def test_the_int8_lane_under_a_width_axis_raises():
    from r2dm_tpu_torch.inference import DDPM, build_diffusion

    cfg = _tiny_cfg()
    match = r"ROADMAP.md queue 1, parallelism \(width axis\): the int8 lane"
    net = set_quant_conv(build_model(cfg, device="cpu"), "w8a8")
    with pytest.raises(ValueError, match=match):
        set_width_shard(net, _world(2))
    with pytest.raises(ValueError, match=match):
        DDPM(build_diffusion(cfg, net), cfg).repaint(torch.zeros(1, 2, 16, 64), torch.ones(1, 2, 16, 64), 2,
                                                     seeds=[0], world=_world(2))
    net = set_width_shard(build_model(cfg, device="cpu"), _world(2))
    with pytest.raises(ValueError, match=match):
        set_quant_conv(net, "w8a8")


def test_a_sharded_call_under_autograd_raises():
    """The halo'd conv and the split GroupNorm have no backward: training
    under a width axis is its own item, and nothing falls back."""
    from r2dm_tpu_torch.ops import act_ringconv, gn_silu

    x = torch.zeros(1, 4, 8, 8, device="meta", requires_grad=True)
    strip = torch.zeros(1, 4, 1, 8, device="meta")
    match = r"width axis\): training"
    with pytest.raises(NotImplementedError, match=match):
        act_ringconv.act_ringconv_halo(x, strip, strip, None, None, torch.zeros(3, 3, 8, 8, device="meta"),
                                       torch.zeros(8, device="meta"), apply_act=False)
    with pytest.raises(NotImplementedError, match=match):
        gn_silu.group_norm_silu_sharded(x, torch.ones(8), torch.zeros(8), 4, 1e-6, True, _world(2))


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


def test_bench_counts_each_data_groups_images_once():
    """Under 2x2 the aggregate is the two data groups' img/s (each group's
    width rank 0), every rank's beside it."""
    rs = [{"value": v, "mfu": 0.1, "mfu_all": 0.1, "ddim32_img_per_s": 2 * v} for v in (1.0, 1.0, 3.0, 3.0)]
    out = bench.aggregate(rs, width_size=2)
    assert out["value"] == 4.0 and out["per_rank_img_per_s"] == [1.0, 1.0, 3.0, 3.0]
    assert out["ddim32_img_per_s"] == 8.0 and out["ranks"] == 4
