"""The port's LiDARGen RefineNet under the width axis on the CPU: gloo ranks
in subprocesses that split each image's columns (``--mesh 1x2``, ``1x4``
and ``2x2``) against one process with the same inputs, and against the JAX
package's forward, loss and gradients: its pads (circular in both axes,
zero, and max pooling's -inf) and their adjoints bit for bit, InstanceNorm++,
the upsample and the max pool with their gradients, the network's forward
with its exact collectives, its loss and every parameter gradient, and
``DDPM.sample``/``repaint(world=)``; and the shard check's errors.

The ranks of each mesh run once a module (``width_runs``) and write every
result to an npz file, as in ``test_torch_port_width.py``. The weights are
in the flax init's distribution drawn with numpy
(``test_torch_port_refinenet.py``'s ``random_variables``). Under a width
axis InstanceNorm++ sums its statistics in fp64 over the ranks, so the
sharded forward is the same bit for bit under every mesh, and within fp32
rounding of one process, whose statistics are torch's fp32 mean and
variance: the decoder's residual units have no norm, its activations reach
about 70 here, and a different rounding of the statistics moves the output
by up to 2.2e-5 (5.3e-6 relative L2), as near as the one process is to
JAX (3.2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_parallel import run

from r2dm_tpu.models.refinenet import LiDARGenRefineNet as JaxRefineNet
from r2dm_tpu_torch.models.refinenet import LiDARGenRefineNet
from r2dm_tpu_torch.utils.weights import refinenet_jax_from_state_dict, refinenet_state_dict_from_jax

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

# the network, its inputs and the ops, run alike by the ranks and by this
# process; a rank runs them on its columns (``world``), this process on the
# whole image (``world=None``). Tensors are NCHW inside the network (W is
# dim 3), NHWC at its ends (dim 2).
SHARED = r'''
import math

import numpy as np
import torch
import torch.nn.functional as F

from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch.inference import DDPM, build_diffusion
from r2dm_tpu_torch.models import refinenet

TINY = dict(in_channels=2, resolution=(16, 64), base_channels=8, channel_multiplier=(1, 2, 2, 2))


def arr(seed, *shape, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale)


def random_state_dict(seed=1):
    """The flax init's distribution, drawn with numpy: conv kernels N(0,
    1/fan_in), biases N(0, 0.1^2), the norms' alpha and scale 1 + N(0,
    0.02^2); coords the network's [0, 1] grid."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in refinenet.LiDARGenRefineNet(**TINY).state_dict().items():
        shape = tuple(v.shape)
        if k == "coords":
            a = v.numpy()
        elif k.endswith(("alpha", "post_affine.weight")):
            a = 1.0 + 0.02 * rng.standard_normal(shape)
        elif len(shape) == 4:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            a = 0.1 * rng.standard_normal(shape)
        sd[k] = torch.from_numpy(np.asarray(a, np.float32))
    return sd


def tiny_net():
    net = refinenet.LiDARGenRefineNet(**TINY)
    net.load_state_dict(random_state_dict())
    return net.eval()


def loss_batch(dtype=torch.float32):
    """x_0 in [-1, 1] (the trainer's data range), steps, noise and a loss
    mask of a b4 batch at 16x64."""
    rng = np.random.default_rng(60)
    x_0 = torch.from_numpy(rng.uniform(-1, 1, (4, 16, 64, 2)).astype(np.float32))
    steps = torch.from_numpy(rng.uniform(0, 1, 4).astype(np.float32))
    batch = x_0, steps, arr(62, 4, 16, 64, 2), (arr(63, 4, 16, 64, 2) > -0.5).float()
    return tuple(t.to(dtype) for t in batch)


def loss_of(net, x_0, steps, noise, mask):
    from r2dm_tpu_torch.diffusion import ContinuousTimeGaussianDiffusion

    return ContinuousTimeGaussianDiffusion(net).p_loss(net, x_0, steps, noise, loss_mask=mask)


def ddpm():
    """The tiny RefineNet in fp64 (its output fp32, as every network's) in
    a DDPM: a free-running chain's first step (t = 1, 1/alpha = 1800, then
    clipped) amplifies any fp32 rounding of the network by that factor
    (ROADMAP.md section 3, item 3)."""
    cfg = port_config.Config(data=port_config.DataConfig(resolution=(16, 64)), model=port_config.ModelConfig(
        architecture="refinenet", base_channels=8, channel_multiplier=(1, 2, 2, 2)))
    return DDPM(build_diffusion(cfg, tiny_net().double()), cfg)


def chains(world, seeds=(5, 6)):
    """A DDIM-4 chain and a RePaint (3 steps, 2 resamples) at b2."""
    known, mask = arr(32, 2, 2, 16, 64), (arr(33, 1, 2, 16, 64) > 0).float()
    return {"ddim": ddpm().sample(2, 4, mode="ddim", seeds=list(seeds), world=world).numpy(),
            "repaint": ddpm().repaint(known, mask, 3, 2, seeds=list(seeds), world=world).numpy()}


def pads():
    """name -> (a rank's pad given its world (None: the whole image), the
    margin on each side of W): the convs' circular pads (p = 1, 2, 4), the
    zero-padded convs' and max pooling's -inf margins."""
    from r2dm_tpu_torch.parallel.width import pad_columns, sharded

    def inf_pad(w):
        if sharded(w):
            return lambda x: pad_columns(x, 2, 2, w, dim=3, edge=-math.inf)
        return lambda x: F.pad(x, (2, 2), value=-math.inf)

    out = {f"circular{p}": ((lambda w, p=p: lambda x: refinenet.pad_hw(x, p, True, w)), p) for p in (1, 2, 4)}
    out["zero1"] = (lambda w: lambda x: refinenet.pad_hw(x, 1, False, w)), 1
    out["inf2"] = inf_pad, 2
    return out


def with_shard(module, w):
    """module's forward as a function of (input, *parameters), run under
    the width axis ``w``."""
    names = [n for n, _ in module.named_parameters()]

    def fn(x, *params):
        for m in module.modules():
            if hasattr(m, "width_shard"):
                m.width_shard = w
        try:
            return torch.func.functional_call(module, dict(zip(names, params)), (x,))
        finally:
            for m in module.modules():
                if hasattr(m, "width_shard"):
                    m.width_shard = None
    return fn


def grad_ops():
    """name -> (the function given a world, its inputs: NCHW x first, then
    the parameters): InstanceNorm++ (random alpha and affine), the
    upsample of u_block1 (8x32 -> 16x64, the rank's size out) and the max
    pool."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(11)
        norm = refinenet.InstanceNormPlus(6)
        with torch.no_grad():
            norm.post_affine.bias.normal_(0, 0.1)
    up, pool = refinenet.BilinearAlignCorners(), refinenet.MaxPool5()

    class Up(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.up = up

        def forward(self, x):
            return self.up(x, (16, 2 * x.shape[3]))

    x = arr(2, 2, 6, 8, 32) + 0.3
    return {"norm": (lambda w: with_shard(norm, w), [x] + [p.detach() for p in norm.parameters()]),
            "upsample": (lambda w: with_shard(Up(), w), [x]),
            "maxpool": (lambda w: with_shard(pool, w), [x])}


def op_grads(fn, inputs, world=None):
    """(y, the gradient of each input) of sum(fn(*inputs) * dy), dy drawn
    for the whole image and cut to the rank's columns under ``world``."""
    from r2dm_tpu_torch import parallel

    leaves = [t.clone().requires_grad_() for t in inputs]
    y = fn(*leaves)
    n = world.width_size if parallel.sharded(world) else 1
    y.backward(parallel.shard_columns(arr(99, *y.shape[:3], y.shape[3] * n), world, dim=3))
    return y.detach(), [t.grad for t in leaves]
'''

RANK = SHARED + r'''
from r2dm_tpu_torch import parallel
from r2dm_tpu_torch.models import layers
from r2dm_tpu_torch.parallel import width as width_mod

OUT, MESHES = __OUT__, __MESHES__
res = {}
counts = {"exchange": 0, "reduce": 0}
real_gather, real_reduce = width_mod._all_gather, width_mod.all_reduce_sum_


def gather_counted(t, world):
    counts["exchange"] += 1
    return real_gather(t, world)


def reduce_counted(t, world):
    counts["reduce"] += 1
    return real_reduce(t, world)


width_mod._all_gather, width_mod.all_reduce_sum_ = gather_counted, reduce_counted


def columns(world, t, dim=3):
    return parallel.shard_columns(t, world, dim)


def total(t, world):
    """The width shares of a gradient or loss summed, then the data mean."""
    t = t.detach().clone()
    torch.distributed.all_reduce(t)
    return t / world.data_size


for mesh in MESHES:
    world = parallel.init("cpu", mesh=mesh)
    tag = mesh.replace("x", "_")
    D, d = world.data_size, world.data_index
    if D == 1:
        # each pad: this rank's padded columns of the whole image's pad, bit for bit; its
        # adjoint: the rank's cotangent of its window against autograd through the whole
        # image's pad of every rank's window
        x = arr(1, 2, 3, 8, 32)
        Wl = x.shape[3] // world.width_size
        for name, (pad, m) in pads().items():
            got = pad(world)(columns(world, x))
            want = pad(None)(x).narrow(3, world.width_rank * Wl, Wl + 2 * m)
            res[f"{tag}_pad_{name}_exact"] = np.array(torch.equal(got, want))
            # integer cotangents: every sum of them is exact, in any order
            dys = [torch.round(arr(20 + r, *got.shape, scale=8.0)) for r in range(world.width_size)]
            xf = x.clone().requires_grad_()
            full = pad(None)(xf)
            sum((full.narrow(3, r * Wl, Wl + 2 * m) * dy).sum() for r, dy in enumerate(dys)).backward()
            xl = columns(world, x).requires_grad_()
            (pad(world)(xl) * dys[world.width_rank]).sum().backward()
            res[f"{tag}_pad_{name}_adjoint_exact"] = np.array(torch.equal(xl.grad, columns(world, xf.grad)))
        # InstanceNorm++, the upsample, the max pool: dx gathered, parameter gradients summed
        for name, (fn, inputs) in grad_ops().items():
            y, grads = op_grads(fn(world), [columns(world, inputs[0])] + inputs[1:], world)
            res[f"{tag}_op_{name}_y"] = parallel.gather_columns(y, world, 3).numpy()
            for i, g in enumerate(grads):
                g = parallel.gather_columns(g, world, 3) if i == 0 else parallel.all_reduce_sum_(g, world)
                res[f"{tag}_op_{name}_d{i}"] = g.numpy()
    # the network's forward on this data group's rows of a b4 batch, its columns, with the
    # collectives it makes; gathered over the width group and then the data groups
    net = layers.set_width_shard(tiny_net(), world)
    x = arr(10, 4, 16, 64, 2)
    rows = slice(d * 4 // D, (d + 1) * 4 // D)
    counts.update(exchange=0, reduce=0)
    with torch.no_grad():
        y = net(columns(world, x[rows], 2), None)
    res[f"{tag}_collectives"] = np.array([counts["exchange"], counts["reduce"]])
    y = parallel.gather_columns(y, world)
    parts = parallel.gather_objects(world, y.numpy())
    if parts is not None:
        res[f"{tag}_net"] = np.concatenate(parts[::world.width_size])
    # the loss and every parameter gradient, fp32 and fp64: the width shares summed, the
    # data mean taken
    for dtype in (torch.float32, torch.float64):
        x_0, steps, noise, mask = loss_batch(dtype)
        net = layers.set_width_shard(tiny_net().to(dtype).train(), world)
        loss = loss_of(net, columns(world, x_0[rows], 2), steps[rows], columns(world, noise[rows], 2),
                       columns(world, mask[rows], 2))
        loss.backward()
        key = f"{tag}_{str(dtype)[6:]}"
        res[f"{key}_loss"] = total(loss, world).numpy()
        for name, p in net.named_parameters():
            res[f"{key}_grad_{name}"] = total(p.grad, world).numpy()
    if mesh == "1x2":
        out = chains(world)
        for name in out:  # the whole scans, gathered over the width group
            res[f"{tag}_chain_{name}"] = out[name]
np.savez(f"{OUT}/rank{torch.distributed.get_rank()}.npz", **res)
'''


def shared():
    ns = {}
    exec(SHARED, ns)
    return ns


@pytest.fixture(scope="module")
def width_runs(tmp_path_factory):
    """{mesh group: [every rank's npz dict]}: two ranks (``1x2``) and four
    (``1x4``, then ``2x2``)."""
    out = {}
    for name, meshes, n in (("two", ["1x2"], 2), ("four", ["1x4", "2x2"], 4)):
        d = tmp_path_factory.mktemp(f"refinenet-width-{name}")
        code = RANK.replace("__OUT__", repr(str(d))).replace("__MESHES__", repr(meshes))
        run(d, "-c", [[code]] * n)
        out[name] = [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]
    return out


@pytest.fixture(scope="module")
def one_rank():
    return shared()


MESHES = [("two", "1_2"), ("four", "1_4"), ("four", "2_2")]
SPLIT_MESHES = [("two", "1_2"), ("four", "1_4")]  # one data group: the op checks run there
PADS = list(shared()["pads"]())
OPS = list(shared()["grad_ops"]())


# ------------------------------------------------------------------ pads
@pytest.mark.parametrize("group,mesh", SPLIT_MESHES)
@pytest.mark.parametrize("pad", PADS)
def test_a_pad_under_a_width_axis_is_the_whole_images_bit_for_bit(width_runs, group, mesh, pad):
    """Each rank's circular (p = 1, 2, 4: both axes wrap, the ring across
    ranks), zero and -inf pad is its window of the whole image's padded
    tensor, and its adjoint gives each rank autograd's gradient of its
    columns through the whole image's pad, bit for bit. The cotangents are
    integers, so a pixel's gradient is exact whatever order its terms (up
    to 4: a window's overlap with its neighbours', the wrap of H) are
    added in, and a term routed to the wrong pixel shows."""
    for r, res in enumerate(width_runs[group]):
        assert bool(res[f"{mesh}_pad_{pad}_exact"]), (r, pad)
        assert bool(res[f"{mesh}_pad_{pad}_adjoint_exact"]), (r, pad)


# ------------------------------------------------------------------- ops
@pytest.mark.parametrize("group,mesh", SPLIT_MESHES)
@pytest.mark.parametrize("op", OPS)
def test_a_sharded_op_and_its_gradients_equal_one_ranks(width_runs, one_rank, group, mesh, op):
    """InstanceNorm++ (its statistics summed over the width group), the
    upsample (one column of each neighbour inside the image, the rank's rows
    of the interpolation matrix) and the max pool (-inf past the image's
    outer columns): the output and dx gathered, the parameter gradients
    summed over the group, against one process, max|err| <= 1e-5 max|ref|."""
    fn, inputs = one_rank["grad_ops"]()[op]
    y, grads = one_rank["op_grads"](fn(None), inputs)
    for r, res in enumerate(width_runs[group]):
        for name, want in [("y", y)] + [(f"d{i}", g) for i, g in enumerate(grads)]:
            got, want = res[f"{mesh}_op_{op}_{name}"], want.numpy()
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (r, name)


def test_the_upsample_reads_at_most_one_column_of_each_neighbour():
    """With align_corners a rank's output columns read its own input columns
    and at most one of each neighbour's, whatever the two sizes: each
    rank's rows of rank_interp_matrix keep every weight of the whole
    matrix's rows."""
    from r2dm_tpu_torch.models.refinenet import interp_matrix, rank_interp_matrix

    for n_in in (8, 16, 32, 64, 512):
        for n_out in (n_in // 4, n_in // 2, 2 * n_in, 8 * n_in):
            full = interp_matrix(n_in, n_out)
            for ranks in (2, 4, 8):
                if n_in % ranks or n_out % ranks:
                    continue
                for rank in range(ranks):
                    m = rank_interp_matrix(n_in, n_out, rank, ranks)
                    rows = full[rank * n_out // ranks:(rank + 1) * n_out // ranks]
                    assert m.shape[1] == n_in // ranks + (rank > 0) + (rank < ranks - 1)
                    assert torch.equal(m.sum(1), rows.sum(1)), (n_in, n_out, ranks, rank)


# --------------------------------------------------------------- network
def _jax_forward(x):
    variables = refinenet_jax_from_state_dict(shared()["random_state_dict"]())
    return np.asarray(jax.jit(JaxRefineNet(**shared()["TINY"]).apply)(variables, jnp.asarray(x), None))


@pytest.mark.parametrize("group,mesh", MESHES)
def test_the_sharded_refinenet_matches_one_rank_and_jax(width_runs, one_rank, group, mesh):
    """The tiny RefineNet's forward under 1x2, 1x4 and 2x2 (the b4 batch
    split over the data axis there), gathered: the same bytes under every
    mesh; against one process, relative L2 <= 1e-5 and max|err| <= 1e-5
    max|ref| (the module docstring); against the flax module on the same
    weights (refinenet_jax_from_state_dict), tests/test_unet_parity.py's
    rtol 1e-4, atol 2e-5."""
    x = one_rank["arr"](10, 4, 16, 64, 2)
    got = width_runs[group][0][f"{mesh}_net"]
    np.testing.assert_array_equal(got, width_runs["two"][0]["1_2_net"])
    with torch.no_grad():
        want = one_rank["tiny_net"]()(x, None).numpy()
    assert np.abs(want).max() > 1e-2
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, _jax_forward(x.numpy()), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("group,mesh", MESHES)
def test_a_sharded_forward_makes_83_exchanges_and_34_sums(width_runs, group, mesh):
    """Per rank and forward: 83 halo exchanges (72 circular convs with a
    margin, the 2 zero-padded convs, 8 max pools, 1 upsample) and 34 sums
    (2 for each of the 17 InstanceNorm++): 117 collectives."""
    for r, res in enumerate(width_runs[group]):
        assert res[f"{mesh}_collectives"].tolist() == [83, 34], r


@pytest.fixture(scope="module")
def one_rank_loss(one_rank):
    """{dtype: (loss, {name: gradient})} of the b4 batch on one process."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        net = one_rank["tiny_net"]().to(dtype).train()
        loss = one_rank["loss_of"](net, *one_rank["loss_batch"](dtype))
        loss.backward()
        out[str(dtype)[6:]] = loss.item(), {n: p.grad.numpy() for n, p in net.named_parameters()}
    return out


@pytest.fixture(scope="module")
def jax_loss(one_rank):
    """(loss, {name: gradient}) of the JAX package's p_loss of the same
    network and batch, ``jax.value_and_grad`` on one device."""
    from r2dm_tpu.diffusion import ContinuousTimeGaussianDiffusion as JaxContinuous

    variables = refinenet_jax_from_state_dict(one_rank["random_state_dict"]())
    ddpm = JaxContinuous(model=JaxRefineNet(**one_rank["TINY"]))
    x_0, steps, noise, mask = (np.asarray(t) for t in one_rank["loss_batch"]())

    def loss(params, x_0, steps, noise, mask):
        return ddpm.p_loss({"params": params, "buffers": variables["buffers"]}, x_0, steps, noise=noise,
                           loss_mask=mask)

    value, grads = jax.jit(jax.value_and_grad(loss))(variables["params"], x_0, steps, noise, mask)
    grads = refinenet_state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)})
    names = [n for n, _ in LiDARGenRefineNet(**one_rank["TINY"]).named_parameters()]
    return float(value), {n: grads[n].numpy() for n in names}


@pytest.mark.parametrize("group,mesh", MESHES)
def test_the_sharded_loss_and_gradients_match_one_rank_and_jax(width_runs, one_rank_loss, jax_loss, group, mesh):
    """The tiny RefineNet's masked min-SNR loss and every parameter gradient
    under 1x2, 1x4 and 2x2 (each rank its columns' share, summed over the
    world and divided by the data size, as the trainer does) against one
    process and ``jax.value_and_grad``: the tolerances of
    test_torch_port_width.py's loss test (rtol 1e-4; atol 2e-5 of the
    largest gradient entry, at least 2e-5). In fp64 against one process to
    rtol 1e-9: max pooling sends each gradient to its window's maximum, so
    where two values of a window nearly tie, fp32 rounding can move a
    gradient entry by far more than its rounding; fp64 leaves no such tie.
    The JAX gradient is the unsharded one: under make_mesh((1, 2)) GSPMD's
    gradient of the max pool (select_and_scatter with W split) is wrong on
    the CPU (ROADMAP.md section 3)."""
    for ref_loss, ref_grads in (one_rank_loss["float32"], jax_loss):
        scale = max(1.0, max(float(np.abs(g).max()) for g in ref_grads.values()))
        for r, res in enumerate(width_runs[group]):
            np.testing.assert_allclose(res[f"{mesh}_float32_loss"], ref_loss, rtol=1e-4, atol=2e-5)
            for name, want in ref_grads.items():
                np.testing.assert_allclose(res[f"{mesh}_float32_grad_{name}"], want, rtol=1e-4, atol=2e-5 * scale,
                                           err_msg=f"rank {r} {name}")
    ref_loss, ref_grads = one_rank_loss["float64"]
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    for r, res in enumerate(width_runs[group]):
        np.testing.assert_allclose(res[f"{mesh}_float64_loss"], ref_loss, rtol=1e-9)
        for name, want in ref_grads.items():
            np.testing.assert_allclose(res[f"{mesh}_float64_grad_{name}"], want, rtol=1e-9, atol=1e-12 * scale,
                                       err_msg=f"rank {r} {name}")


# ----------------------------------------------------------------- chains
@pytest.fixture(scope="module")
def one_rank_chains(one_rank):
    return one_rank["chains"](None)


@pytest.mark.parametrize("name", ["ddim", "repaint"])
def test_a_sharded_refinenet_chain_equals_one_rank(width_runs, one_rank_chains, name):
    """DDPM.sample (DDIM-4) and repaint(world=) of the tiny RefineNet (fp64,
    ``ddpm``) under 1x2: one process's samples with the same seeds, to
    JAX's own mesh-parity tolerance (tests/test_inference.py:254)."""
    got = width_runs["two"][0][f"1_2_chain_{name}"]
    want = one_rank_chains[name]
    assert np.isfinite(want).all() and want.std() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ------------------------------------------------------------ shard check
@pytest.mark.parametrize("resolution,width,level", [((16, 64), 16, "level 2"), ((16, 60), 4, "level 1"),
                                                    ((16, 64), 3, "level 1")])
def test_a_width_that_does_not_split_the_refinenet_raises(resolution, width, level):
    """W must split into an even number of columns a rank (the average pool
    to level 2 stays local) with at least 4 a rank at half width (the
    dilation-4 convs' halo); set_width_shard leaves the network as it was."""
    from r2dm_tpu_torch import parallel
    from r2dm_tpu_torch.models import layers

    net = LiDARGenRefineNet(in_channels=2, resolution=resolution, base_channels=8)
    with pytest.raises(ValueError, match=level):
        layers.set_width_shard(net, parallel.World(rank=0, size=width, width_size=width))
    assert layers.width_shard_of(net) is None
    net.check_width_shard(2)
