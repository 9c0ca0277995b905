"""The LiDARGen RefineNet of the port against the JAX package and the
captured reference golden, in fp32 on the CPU: the forward (golden and flax
module), the interpolation, the three weight conversions leaf by leaf,
``setup_model`` from a reference ``.pth`` and a msgpack checkpoint, a train
step against ``make_train_step``, the checkpoint read across the packages
both ways, and ``python -m r2dm_tpu_torch.train --model.architecture
refinenet`` with resume. Inputs are made with numpy from a seed.

Tolerances: fp32 rtol 1e-4, atol 2e-5 (tests/test_unet_parity.py:50) unless
a test says why it needs another.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from r2dm_tpu import checkpoint as jax_checkpoint
from r2dm_tpu import setup_model as jax_setup_model
from r2dm_tpu.config import Config as JaxConfig
from r2dm_tpu.config import DataConfig, ModelConfig, TrainingConfig
from r2dm_tpu.config import asdict as jax_asdict
from r2dm_tpu.diffusion import ContinuousTimeGaussianDiffusion as JaxContinuous
from r2dm_tpu.diffusion.base import normal as jax_normal
from r2dm_tpu.diffusion.base import split_key
from r2dm_tpu.models.refinenet import LiDARGenRefineNet as JaxRefineNet
from r2dm_tpu.training import EMAConfig as JaxEMAConfig
from r2dm_tpu.training import init_train_state as jax_init_train_state
from r2dm_tpu.training import make_optimizer as jax_make_optimizer
from r2dm_tpu.training import make_train_step as jax_make_train_step
from r2dm_tpu.utils.torch_import import (
    convert_refinenet_state_dict,
    export_refinenet_state_dict,
    refinenet_variables_from_reference,
)
from r2dm_tpu_torch import checkpoint, setup_model
from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch.diffusion import ContinuousTimeGaussianDiffusion
from r2dm_tpu_torch.inference import build_model
from r2dm_tpu_torch.models.refinenet import LiDARGenRefineNet, interp_matrix, unit_grid
from r2dm_tpu_torch.train import main as train_main
from r2dm_tpu_torch.train import resume
from r2dm_tpu_torch.training import EMAConfig, init_train_state, make_optimizer, make_train_step
from r2dm_tpu_torch.utils.weights import (
    from_jax,
    reference_state_dict,
    refinenet_jax_from_state_dict,
    refinenet_state_dict_from_jax,
    to_jax,
)

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
TINY = dict(in_channels=2, resolution=(16, 64), base_channels=8, channel_multiplier=(1, 2, 2, 2))
RTOL, ATOL = 1e-4, 2e-5


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(got, ref, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol, err_msg=what)


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN / "tiny_refinenet.npz")
    return g, {k[4:]: g[k] for k in g.files if k.startswith("sd::")}


@pytest.fixture(scope="module")
def random_variables():
    """Random weights in the flax init's distribution, drawn with numpy (the
    flax init itself takes 12 s to compile here): conv kernels N(0,
    1/fan_in) (lecun normal), biases N(0, 0.1^2) so none is zero, the norms'
    alpha and scale 1 + N(0, 0.02^2) (refinenet.py:65-67); as a flax tree,
    with the [0, 1] grid as coords."""
    net = LiDARGenRefineNet(**TINY)
    rng = np.random.default_rng(1)
    sd = {}
    for k, v in net.state_dict().items():
        shape = tuple(v.shape)
        if k == "coords":
            sd[k] = v
        elif k.endswith(("alpha", "post_affine.weight")):
            sd[k] = t(1.0 + 0.02 * rng.standard_normal(shape))
        elif len(shape) == 4:
            sd[k] = t(rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:])))
        else:
            sd[k] = t(0.1 * rng.standard_normal(shape))
    return refinenet_jax_from_state_dict(sd)


def test_refinenet_matches_the_reference_golden(golden):
    """The captured reference forward (tools/gen_goldens.py) through the
    ``sd::*`` weights, to 1e-5 relative (the golden's own rtol 1e-3, atol
    1e-4: tighter holds; measured 1.5e-8 against values up to 0.1)."""
    g, sd = golden
    net = LiDARGenRefineNet(**TINY)
    net.load_state_dict(reference_state_dict(sd), strict=True)
    with torch.no_grad():
        y = net(t(np.transpose(g["x"], (0, 2, 3, 1))), None)
    assert y.dtype == torch.float32 and y.is_contiguous()
    close(y, np.transpose(g["y"], (0, 2, 3, 1)), rtol=1e-5, atol=1e-6)
    # the buffer the reference saved is the [0, 1] grid the port builds (it
    # with torch.linspace in fp32, the port and the flax module with numpy:
    # one fp32 step apart at most)
    np.testing.assert_allclose(sd["coords"], unit_grid((16, 64)), rtol=0, atol=6e-8)


def test_refinenet_matches_flax_random_init(random_variables):
    """A forward of random weights against the flax module (jitted), with
    timesteps that must not matter; the port's parameter tree has the flax
    init's paths and shapes (jax.eval_shape, nothing compiled)."""
    jnet = JaxRefineNet(**TINY)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), jnp.zeros((1, 16, 64, 2)), None)
    assert {k: v.shape for k, v in _leaves(random_variables).items()} == \
        {jax.tree_util.keystr(p): v.shape for p, v in jax.tree_util.tree_leaves_with_path(shapes)}
    x = np.random.default_rng(2).standard_normal((2, 16, 64, 2)).astype(np.float32)
    ref = np.asarray(jax.jit(jnet.apply)(random_variables, jnp.asarray(x), None))
    net = LiDARGenRefineNet(**TINY)
    net.load_state_dict(refinenet_state_dict_from_jax(random_variables))
    with torch.no_grad():
        y = net(t(x), torch.tensor([0.3, 0.9]))
        assert torch.equal(y, net(t(x), torch.tensor([0.0, 0.0])))
    assert float(np.abs(ref).max()) > 1e-2
    close(y, ref)


def test_bilinear_align_corners_is_f_interpolate():
    """The two interpolation matmuls against F.interpolate(align_corners=
    True) and the JAX function's matrices, including a size-1 axis."""
    from r2dm_tpu.models.refinenet import bilinear_align_corners as jax_bilinear
    from r2dm_tpu_torch.models.refinenet import BilinearAlignCorners

    x = np.random.default_rng(3).standard_normal((2, 3, 8, 32)).astype(np.float32)
    up = BilinearAlignCorners()
    got = up(t(x), (16, 64))
    ref = F.interpolate(t(x), size=(16, 64), mode="bilinear", align_corners=True)
    close(got, ref, rtol=1e-5, atol=1e-6)
    close(got, np.transpose(np.asarray(jax_bilinear(jnp.asarray(x.transpose(0, 2, 3, 1)), (16, 64))), (0, 3, 1, 2)),
          rtol=1e-6, atol=1e-6)
    assert up(t(x), (8, 32)) is not None and torch.equal(up(t(x), (8, 32)), t(x))
    np.testing.assert_array_equal(interp_matrix(1, 4).numpy(), np.ones((4, 1), np.float32))


def test_the_three_conversions_match_jax_leaf_by_leaf(golden, random_variables):
    """reference .pth -> port (prefixes of the EMA wrapper stripped, the
    online model, ``initted`` and ``step`` dropped, as JAX inference.py:
    781-791), flax -> port, and port -> flax: the same leaves as JAX's
    convert_refinenet_state_dict / refinenet_variables_from_reference /
    export_refinenet_state_dict, bit for bit."""
    _, sd = golden
    wrapped = {**{f"ema_model.model.{k}": v for k, v in sd.items()},
               **{f"online_model.model.{k}": v * 0 for k, v in sd.items()},
               "initted": np.array(True), "step": np.array(7)}
    port = reference_state_dict(wrapped)
    assert set(port) == set(sd)
    params, buffers = convert_refinenet_state_dict(sd)
    want = _leaves({"params": params, "buffers": buffers})
    assert _leaves(refinenet_jax_from_state_dict(port)).keys() == want.keys()
    for k, v in _leaves(refinenet_jax_from_state_dict(port)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    # JAX's own variables of the reference dict, back through the port
    back = refinenet_state_dict_from_jax(jax.tree.map(np.asarray, refinenet_variables_from_reference(sd)))
    assert back.keys() == port.keys()
    for k in port:
        assert torch.equal(back[k], port[k]), k
    # export: the reference keys JAX writes for a flax tree, and the same values
    exported = export_refinenet_state_dict(random_variables)
    mine = refinenet_state_dict_from_jax(random_variables)
    assert {k[len("model."):] for k in exported} == set(mine)
    for k, v in exported.items():
        np.testing.assert_array_equal(v, mine[k[len("model."):]].numpy(), err_msg=k)
    # the dispatchers pick the pair by architecture
    assert to_jax(mine, "refinenet").keys() == {"params", "buffers"}
    assert from_jax(random_variables, "refinenet").keys() == mine.keys()


def _tiny_cfg() -> JaxConfig:
    return JaxConfig(data=DataConfig(resolution=(16, 64)),
                     model=ModelConfig(architecture="refinenet", base_channels=8, channel_multiplier=(1, 2, 2, 2)))


def _same_setup(path, jax_path=None):
    """setup_model of both packages on one checkpoint: the same cfg, the
    same weights, the same ray angles (the network's own coords), and the
    same forward."""
    ddpm, lidar, cfg = setup_model(path, device="cpu")
    jddpm, jlidar, jcfg = jax_setup_model(jax_path or path)
    assert port_config.asdict(cfg) == jax_asdict(jcfg)
    assert cfg.model.architecture == "refinenet" and isinstance(ddpm.model, LiDARGenRefineNet)
    mine = refinenet_jax_from_state_dict(ddpm.model.state_dict())
    want = _leaves(jax.tree.map(np.asarray, jddpm.variables))
    assert _leaves(mine).keys() == want.keys()
    for k, v in _leaves(mine).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    np.testing.assert_array_equal(lidar.ray_angles.numpy(), np.asarray(jlidar.ray_angles))
    np.testing.assert_allclose(lidar.ray_angles.numpy(), unit_grid((16, 64))[0].transpose(1, 2, 0), rtol=0, atol=6e-8)
    x = np.random.default_rng(4).standard_normal((1, 16, 64, 2)).astype(np.float32)
    with torch.no_grad():
        y = ddpm.model(t(x), torch.zeros(1))
    close(y, jax.jit(jddpm.diffusion.model.apply)(jddpm.variables, jnp.asarray(x), None))
    return ddpm


def test_setup_model_from_a_reference_pth_and_a_msgpack(golden, random_variables, tmp_path):
    _, sd = golden
    cfg = jax_asdict(_tiny_cfg())
    pth = tmp_path / "refinenet.pth"
    torch.save({"cfg": cfg, "weights": {f"model.{k}": t(v) for k, v in sd.items()},
                "ema_weights": {**{f"ema_model.model.{k}": t(v) for k, v in sd.items()},
                                "initted": torch.tensor(True), "step": torch.tensor(3)},
                "global_step": 3}, pth)
    _same_setup(str(pth))
    # the JAX package writes the msgpack; the coords buffer is the grid
    pack = tmp_path / "refinenet.msgpack"
    jax_checkpoint.save_checkpoint(str(pack), cfg, random_variables, ema_weights=random_variables, step=5)
    ddpm = _same_setup(str(pack))
    # the samplers drive it like the EfficientUNet
    x = ddpm.sample(2, 2, seeds=[0, 1], mode="ddim")
    assert tuple(x.shape) == (2, 2, 16, 64) and bool(torch.isfinite(x).all())


def test_a_pth_without_coords_keeps_the_networks_grid(golden, tmp_path):
    """A RefineNet checkpoint with no ``coords`` buffer: the network keeps its
    own [0, 1] grid (an EfficientUNet's would be the sensor's angles,
    ``model_coords``), and LiDARUtility takes that grid as the ray angles,
    as the JAX package hands it the network's coords."""
    _, sd = golden
    pth = tmp_path / "no-coords.pth"
    torch.save({"cfg": jax_asdict(_tiny_cfg()),
                "weights": {f"model.{k}": t(v) for k, v in sd.items() if k != "coords"}}, pth)
    ddpm, lidar, _ = setup_model(str(pth), device="cpu")
    grid = unit_grid((16, 64))
    np.testing.assert_array_equal(ddpm.model.coords.numpy(), grid)
    np.testing.assert_array_equal(lidar.ray_angles.numpy(), grid[0].transpose(1, 2, 0))


TRAIN = dict(lr=2e-3, lr_warmup_steps=2, num_steps=100)
EMA = dict(update_after_step=0, update_every=1)


def test_train_steps_match_jax(random_variables):
    """Two AdamW + EMA steps of the RefineNet against the JAX step with the
    same batch, timesteps and noise: loss, gradient norm, parameters and EMA
    parameters (the parameters to lr-scaled atol 2e-5, as the EfficientUNet
    test: Adam moves an entry whose gradient is fp32 noise by up to lr)."""
    jnet = JaxRefineNet(**TINY)
    ddpm = JaxContinuous(model=jnet)
    tx, _ = jax_make_optimizer(TrainingConfig(**TRAIN))
    jstep = jax.jit(jax_make_train_step(ddpm, tx, JaxEMAConfig(**EMA)))
    jstate = jax_init_train_state(random_variables["params"], random_variables["buffers"], tx)

    model = LiDARGenRefineNet(**TINY)
    model.load_state_dict(refinenet_state_dict_from_jax(random_variables))
    optimizer, scheduler = make_optimizer(model.parameters(), port_config.TrainingConfig(**TRAIN))
    state = init_train_state(model, optimizer, scheduler)
    pstep = make_train_step(ContinuousTimeGaussianDiffusion(model), optimizer, scheduler, EMAConfig(**EMA))
    x_0 = np.random.default_rng(5).uniform(-1, 1, (2, 16, 64, 2)).astype(np.float32)
    for i in range(2):
        key = jax.random.key(10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(x_0), key, None)
        t_key, n_key = split_key(key)
        steps = np.asarray(ddpm.sample_timesteps(t_key, 2))
        noise = np.asarray(jax_normal(n_key, x_0.shape))
        pm = pstep(state, t(x_0), steps=t(steps), noise=t(noise))
        close(pm["loss"], jm["loss"], what=f"loss, step {i}")
        close(pm["grad_norm"], jm["grad_norm"], what=f"grad norm, step {i}")
        params = refinenet_state_dict_from_jax({"params": jstate.params})
        emas = refinenet_state_dict_from_jax({"params": jstate.ema_params})
        ema_sd = dict(state.ema_model.named_parameters())
        for name, p in model.named_parameters():
            close(p, params[name], atol=2e-5, what=f"{name}, step {i}")
            close(ema_sd[name], emas[name], atol=2e-5, what=f"EMA {name}, step {i}")


def _port_state(variables):
    model = LiDARGenRefineNet(**TINY)
    model.load_state_dict(refinenet_state_dict_from_jax(variables))
    optimizer, scheduler = make_optimizer(model.parameters(), port_config.TrainingConfig(**TRAIN))
    return init_train_state(model, optimizer, scheduler)


def test_checkpoints_cross_the_packages_both_ways(random_variables, tmp_path):
    """A port-written msgpack loads in JAX's setup_model and restore_opt_state
    (weights, EMA, AdamW moments and counts); a JAX-written training
    checkpoint resumes in the port (weights, EMA, moments, step)."""
    state = _port_state(random_variables)
    step = make_train_step(ContinuousTimeGaussianDiffusion(state.model), state.optimizer, state.scheduler,
                           EMAConfig(**EMA))
    x_0 = np.random.default_rng(6).uniform(-1, 1, (2, 16, 64, 2)).astype(np.float32)
    for i in range(2):
        step(state, t(x_0), torch.Generator().manual_seed(i))
    path = checkpoint.save_checkpoint(str(tmp_path / "port.msgpack"), jax_asdict(_tiny_cfg()), state)
    jddpm, _, jcfg = jax_setup_model(path)
    assert jcfg.model.architecture == "refinenet"
    mine = _leaves(refinenet_jax_from_state_dict(state.ema_model.state_dict()))
    for k, v in _leaves(jax.tree.map(np.asarray, jddpm.variables)).items():
        np.testing.assert_array_equal(v, mine[k], err_msg=k)
    ck = jax_checkpoint.load_checkpoint(path)
    tx, _ = jax_make_optimizer(TrainingConfig(**TRAIN))
    opt = jax_checkpoint.restore_opt_state(tx.init(random_variables["params"]), ck["opt_state"])
    assert int(opt[1][0].count) == 2 and ck["global_step"] == 2
    mu = refinenet_state_dict_from_jax({"params": opt[1][0].mu})
    for name, p in state.model.named_parameters():
        np.testing.assert_array_equal(mu[name].numpy(), state.optimizer.state[p]["exp_avg"].numpy(), err_msg=name)

    # the other way: a JAX training state, written by the JAX package
    jstate = jax_init_train_state(random_variables["params"], random_variables["buffers"], tx)
    jstep = jax.jit(jax_make_train_step(JaxContinuous(model=JaxRefineNet(**TINY)), tx, JaxEMAConfig(**EMA)))
    jstate, _ = jstep(jstate, jnp.asarray(x_0), jax.random.key(0), None)
    jpath = str(tmp_path / "jax.msgpack")
    jax_checkpoint.save_checkpoint(
        jpath, jax_asdict(_tiny_cfg()), {"params": jstate.params, "buffers": jstate.buffers},
        ema_weights={"params": jstate.ema_params, "buffers": jstate.buffers},
        opt_state=jax.tree.map(np.asarray, jstate.opt_state), step=int(jstate.step))
    fresh = _port_state(random_variables)
    assert resume(fresh, jpath) == 1 and fresh.updates == 1
    params = refinenet_state_dict_from_jax({"params": jstate.params})
    nu = refinenet_state_dict_from_jax({"params": jstate.opt_state[1][0].nu})
    for name, p in fresh.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[name].numpy(), err_msg=name)
        np.testing.assert_array_equal(fresh.optimizer.state[p]["exp_avg_sq"].numpy(), nu[name].numpy(), err_msg=name)


def test_train_cli_trains_and_resumes_a_refinenet(tmp_path, monkeypatch):
    """``python -m r2dm_tpu_torch.train --model.architecture refinenet`` on
    the synthetic set: 3 steps, then 2 resumed; the checkpoint is the
    RefineNet's flax tree with the trainer's coords (the sensor's angles, as
    the JAX trainer sets them, train.py:219-225)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("R2DM_SYNTH_SCANS", "8")
    out = tmp_path / "run"
    flags = ["--device", "cpu", "--data.dataset", "synthetic", "--data.projection", "spherical-256",
             "--data.resolution", "16,64", "--model.architecture", "refinenet", "--model.base_channels", "8",
             "--model.channel_multiplier", "1,2,2,2", "--training.batch_size_train", "2",
             "--training.mixed_precision", "no", "--training.steps_save_image", "100",
             "--training.output_dir", str(out)]
    assert train_main(flags + ["--training.num_steps", "3"]) == 0
    ck = checkpoint.load_checkpoint(str(out / "checkpoint.msgpack"))
    assert ck["global_step"] == 3 and "out_norm" in ck["weights"]["params"]
    cfg = port_config.from_dict(ck["cfg"])
    from r2dm_tpu_torch.inference import model_coords

    np.testing.assert_array_equal(np.asarray(ck["weights"]["buffers"]["coords"]), model_coords(cfg))
    assert train_main(flags + ["--training.num_steps", "5", "--training.resume", str(out / "checkpoint.msgpack")]) == 0
    ck2 = checkpoint.load_checkpoint(str(out / "checkpoint.msgpack"))
    assert ck2["global_step"] == 5 and int(ck2["opt_state"]["1"]["0"]["count"]) == 5
    k2 = ck2["weights"]["params"]["in_conv"]["kernel"]
    assert np.isfinite(k2).all() and not np.array_equal(k2, ck["weights"]["params"]["in_conv"]["kernel"])
    model = build_model(cfg, device="cpu")
    assert isinstance(model, LiDARGenRefineNet)
