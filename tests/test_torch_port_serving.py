"""The serving slice of the port against the JAX package, on the CPU: the
msgpack checkpoint reader, unfolding coordinates, the discrete-time and flow
processes, DPM-Solver++(2M), RePaint with the JAX key splits replayed, and
the DDPM surface (progress, return_all, batch chunking, mode checks)."""

import json
import re
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2dm_tpu import Config as JaxConfig
from r2dm_tpu import setup_model as jax_setup_model
from r2dm_tpu.checkpoint import save_checkpoint
from r2dm_tpu.config import DataConfig, DiffusionConfig, ModelConfig, asdict
from r2dm_tpu.diffusion import schedules as jax_schedules
from r2dm_tpu.diffusion.base import as_typed_key, split_key
from r2dm_tpu.diffusion.base import normal as jax_normal
from r2dm_tpu.inference import build_model as jax_build_model
from r2dm_tpu.inference import model_coords as jax_model_coords
from r2dm_tpu.utils.torch_import import export_unet_state_dict, variables_from_reference
from r2dm_tpu_torch import checkpoint, setup_model
from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch.diffusion import DiscreteTimeGaussianDiffusion, schedules
from r2dm_tpu_torch.inference import DDPM, build_model, model_coords, pretrained_r2dm, setup_rng
from r2dm_tpu_torch.models.efficient_unet import EfficientUNet
from r2dm_tpu_torch.utils.weights import reference_state_dict

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
TINY_MODEL = dict(base_channels=16, gn_num_groups=4, attn_num_heads=4, num_residual_blocks=(1, 1, 1, 1))
SHAPE = (2, 16, 64, 2)


def tiny_cfg(timestep_type: str = "continuous") -> JaxConfig:
    return JaxConfig(
        data=DataConfig(resolution=(16, 64)),
        model=ModelConfig(**TINY_MODEL),
        diffusion=DiffusionConfig(timestep_type=timestep_type),
    )


@pytest.fixture(scope="module")
def variables():
    """A random tiny config-H-shaped flax tree with a non-zero out_conv."""
    cfg = tiny_cfg()
    params = jax_build_model(cfg).init(jax.random.key(0), jnp.zeros((1, 16, 64, 2)), jnp.zeros((1,)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda l: rng.standard_normal(l.shape).astype(np.float32) * 0.05, params)
    return {"params": params, "buffers": {"coords": jax_model_coords(cfg)}}


@pytest.fixture(scope="module")
def families(variables):
    """(JAX DDPM, port DDPM) for each timestep type, on the same weights."""
    out = {}
    for tt in ("continuous", "discrete", "flow"):
        ckpt = {"cfg": asdict(tiny_cfg(tt)), "weights": export_unet_state_dict(variables)}
        out[tt] = (jax_setup_model(ckpt, ema=False)[0], setup_model(ckpt, ema=False, device="cpu")[0])
    return out


def x_T(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


def assert_chain_close(got: torch.Tensor, ref) -> None:
    """The DDIM-chain tolerance (test_torch_port_sampling.py): the step from
    t = 1 divides by alpha(1) = 5.5e-4, so rtol 1e-4 on top of atol 1e-4,
    and a median of 1e-6."""
    ref = np.asarray(ref)
    assert float(np.abs(ref).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert float(np.median(np.abs(got.numpy() - ref))) <= 1e-6


# ------------------------------------------------------------- msgpack reader
def test_msgpack_decoder_reads_every_type_flax_writes(monkeypatch):
    bf16 = np.arange(-6, 6, dtype=np.float32).reshape(3, 4).astype(jnp.bfloat16)
    big = np.arange(3000, dtype=np.float32).reshape(30, 100)
    tree = {
        "none": None, "t": True, "f": False,
        "ints": [0, 5, 127, 200, 70000, 2**40, -5, -33, -200, -70000, -(2**40)],
        "floats": [1.5, -2.25e300], "short": "cfg", "long": "x" * 300, "bytes": b"\x00\x01" * 200,
        "nested": {"a": {"b": [1, [2, {"c": "d"}]]}},
        "scalar": np.float32(0.5), "i64": np.int64(-7),
        "bf16": bf16, "big": big, "i32": np.arange(7, dtype=np.int32), "empty": np.zeros((0, 3), np.float16),
        "zero_d": np.asarray(3.0, np.float64),
    }
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)  # only `big` is chunked
    data = flax.serialization.msgpack_serialize(tree)
    ref = flax.serialization.msgpack_restore(data)
    got = checkpoint.msgpack_restore(data)
    assert set(got) == set(ref)
    for k in ("none", "t", "f", "ints", "floats", "short", "long", "bytes", "nested"):
        assert got[k] == ref[k], k
    assert type(got["scalar"]) is np.float32 and got["scalar"] == ref["scalar"]
    assert type(got["i64"]) is np.int64 and got["i64"] == ref["i64"]
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf16"].view(torch.int16).numpy(), np.asarray(ref["bf16"]).view(np.int16))
    for k in ("big", "i32", "empty", "zero_d"):
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k])
    with pytest.raises(ValueError, match="ext type 2"):
        checkpoint.msgpack_restore(flax.serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.msgpack_restore(data[:-3])


def test_msgpack_checkpoint_loads_like_the_jax_package(variables, tmp_path, monkeypatch):
    """save_checkpoint with fp32 weights, bf16 EMA weights, an opt_state and
    chunked arrays: the reader's arrays equal flax's bit for bit, and
    setup_model matches the JAX package's forward."""
    import optax

    ema = jax.tree.map(lambda v: np.asarray(v).astype(jnp.bfloat16), variables)
    ema["buffers"] = variables["buffers"]
    opt_state = optax.adamw(1e-4).init(jax.tree.map(jnp.asarray, variables["params"]))
    path = str(tmp_path / "checkpoint.msgpack")
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1 << 14)  # the largest convs go chunked
    save_checkpoint(path, asdict(tiny_cfg()), variables, ema_weights=ema, opt_state=opt_state, step=7)
    raw = open(path, "rb").read()
    assert b"__msgpack_chunked_array__" in raw
    ref = flax.serialization.msgpack_restore(raw)
    got = checkpoint.load_checkpoint(path)
    assert got["global_step"] == 7 and got["cfg"] == json.loads(ref["cfg"])
    n = 0
    for part in ("weights", "ema_weights", "opt_state"):
        flat_ref = jax.tree_util.tree_leaves_with_path(ref[part])
        flat_got = dict(jax.tree_util.tree_leaves_with_path(got[part], is_leaf=lambda x: isinstance(x, torch.Tensor)))
        assert len(flat_ref) == len(flat_got)
        for p, r in flat_ref:
            g = flat_got[p]
            if isinstance(g, torch.Tensor):
                assert r.dtype == jnp.bfloat16
                np.testing.assert_array_equal(g.view(torch.int16).numpy(), np.asarray(r).view(np.int16))
            else:
                assert g.dtype == r.dtype and g.shape == r.shape
                np.testing.assert_array_equal(g, r)
            n += 1
    assert n > 100

    jddpm = jax_setup_model(path, ema=False)[0]
    ddpm, lidar, cfg = setup_model(path, ema=False, device="cpu")
    x = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    cond = np.array([2.0, -3.0], np.float32)
    ref_y = jddpm.diffusion.apply_fn(jddpm.variables, jnp.asarray(x), jnp.asarray(cond))
    with torch.no_grad():
        y = ddpm.model(torch.from_numpy(x), torch.from_numpy(cond))
    assert float(np.abs(np.asarray(ref_y)).max()) > 1e-2
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=1e-4, atol=2e-5)
    # ema=True takes the bf16 tree, widened to fp32
    ddpm_ema = setup_model(path, ema=True, device="cpu")[0]
    w = ddpm_ema.model.d_block1.residual_blocks[0].conv1.weight
    k = np.asarray(ema["params"]["d_block1"]["res0"]["conv1"]["conv"]["kernel"]).astype(np.float32)
    np.testing.assert_array_equal(w.detach().numpy(), np.transpose(k, (3, 2, 0, 1)))
    assert cfg.data.resolution == (16, 64) and lidar.ray_angles.shape == (16, 64, 2)


def test_msgpack_checkpoint_at_config_h_loads_every_key(tmp_path):
    """A full-width config-H checkpoint: the flax tree comes from the JAX
    package's reference importer; every state_dict key and shape of the
    port's model is filled. No forward runs at this size."""
    cfg = port_config.Config()
    net = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    ref_sd = {f"model.{k}": rng.standard_normal(v.shape).astype(np.float32) for k, v in net.state_dict().items()}
    jvars = jax.tree.map(np.asarray, variables_from_reference({k[6:]: v for k, v in ref_sd.items()}))
    path = str(tmp_path / "config_h.msgpack")
    save_checkpoint(path, port_config.asdict(cfg), jvars)
    ddpm = setup_model(path, ema=False, device="cpu")[0]
    got = ddpm.model.state_dict()
    assert got.keys() == net.state_dict().keys()
    for k, v in net.state_dict().items():
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), ref_sd[f"model.{k}"], err_msg=k)


# ---------------------------------------------------------- unfolding coords
@pytest.mark.parametrize("dataset", ["kitti_360", "kitti_raw"])
@pytest.mark.parametrize("resolution", [(64, 1024), (16, 64)])
def test_unfolding_coords_match_jax(dataset, resolution, monkeypatch):
    monkeypatch.delenv("R2DM_ANGLES_DIR", raising=False)
    jcfg = JaxConfig(data=DataConfig(dataset=dataset, projection="unfolding-2048", resolution=resolution))
    cfg = port_config.from_dict(asdict(jcfg))
    got = model_coords(cfg)
    ref = jax_model_coords(jcfg)
    assert got.shape == (*resolution, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_unfolding_coords_directory_and_setup_model(variables, tmp_path, monkeypatch):
    monkeypatch.setenv("R2DM_ANGLES_DIR", str(tmp_path))
    cfg = port_config.from_dict(asdict(JaxConfig(data=DataConfig(projection="unfolding-2048"))))
    with pytest.raises(FileNotFoundError, match="unfolding angle table"):
        model_coords(cfg)
    monkeypatch.delenv("R2DM_ANGLES_DIR")
    jcfg = tiny_cfg()
    jcfg.data.projection = "unfolding-2048"
    ckpt = {"cfg": asdict(jcfg), "weights": {"params": variables["params"]}}  # no coords buffer
    ddpm, lidar, _ = setup_model(ckpt, ema=False, device="cpu")
    np.testing.assert_array_equal(ddpm.model.coords[0].permute(1, 2, 0).numpy(), jax_model_coords(jcfg))
    np.testing.assert_array_equal(lidar.ray_angles.numpy(), jax_model_coords(jcfg))


# ------------------------------------------------------------------ discrete
def test_beta_tables_match_golden_and_jax():
    g = np.load(GOLDEN / "schedules.npz")
    for name in ("linear", "cosine", "sigmoid"):
        ours = schedules.make_beta_table(name, 1000)
        np.testing.assert_array_equal(ours, jax_schedules.make_beta_table(name, 1000))
        np.testing.assert_allclose(ours.astype(np.float32), g[f"beta_{name}"], rtol=5e-5, atol=1e-8, err_msg=name)
        for k, v in schedules.discrete_tables(name, 64).items():
            np.testing.assert_array_equal(v, jax_schedules.discrete_tables(name, 64)[k], err_msg=k)
    with pytest.raises(ValueError):
        schedules.make_beta_table("quadratic", 10)


def test_discrete_p_step_matches_golden():
    g = np.load(GOLDEN / "tiny_diffusion_discrete.npz")
    c = np.load(GOLDEN / "tiny_diffusion_continuous.npz")
    net = EfficientUNet(
        in_channels=2, resolution=(16, 64), base_channels=16, num_residual_blocks=(1, 1, 1, 1),
        gn_num_groups=4, attn_num_heads=4, coords_encoding="fourier_features",
    )
    net.load_state_dict(reference_state_dict({k[4:]: c[k] for k in c.files if k.startswith("sd::")}))
    diff = DiscreteTimeGaussianDiffusion(net, prediction_type="eps", noise_schedule="cosine", num_training_steps=64)
    x_t = torch.from_numpy(np.transpose(g["x_t"], (0, 2, 3, 1)).copy())
    steps = torch.from_numpy(g["steps"].astype(np.int64))
    with torch.no_grad():
        for mode, key in (("ddpm", "ddpm_mean"), ("ddim", "ddim_out")):
            got = diff.p_step(x_t, steps, noise=None, mode=mode)
            np.testing.assert_allclose(got.numpy(), np.transpose(g[key], (0, 2, 3, 1)), rtol=1e-4, atol=1e-4)
        w = diff.get_loss_weight(steps)
        np.testing.assert_allclose(w.numpy(), g["loss_weight"], rtol=1e-5)


@pytest.mark.parametrize("mode", ["ddpm", "ddim"])
def test_discrete_chain_with_injected_noise_matches_jax(families, mode):
    jddpm, ddpm = families["discrete"]
    x = x_T(4)
    noise = np.random.default_rng(5).standard_normal((3, *SHAPE)).astype(np.float32)
    p_step = jax.jit(jddpm.diffusion.p_step, static_argnames=("mode",))
    ref = jnp.asarray(x)
    for i, t in enumerate((2, 1, 0)):
        ref = p_step(jddpm.variables, ref, jnp.full((2,), t, jnp.int32), noise=jnp.asarray(noise[i]), mode=mode)
    got = ddpm.sample(2, 3, mode=mode, x_T=torch.from_numpy(x), noise=torch.from_numpy(noise), data_format="NHWC")
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


# -------------------------------------------------- dpmpp_2m, ddim and flow
@pytest.mark.parametrize("mode", ["dpmpp_2m", "ddim"])
def test_continuous_solvers_match_jax(families, mode):
    jddpm, ddpm = families["continuous"]
    x = x_T(1)  # the x_T and weights of test_ddim_chain_matches_jax
    diff = jddpm.diffusion
    ts = jnp.linspace(1.0, 0.0, 5, dtype=jnp.float32)
    if mode == "dpmpp_2m":
        so = jnp.asarray(ddpm.diffusion.dpmpp_second_order(4))
        ref = jax.jit(diff.dpmpp_2m_segment)(
            jddpm.variables, jnp.asarray(x), jnp.zeros(SHAPE), jnp.zeros((2, 1, 1, 1)), jax.random.key(0), ts, so,
        )[0]
    else:
        ref, _ = jax.jit(diff.sample_segment, static_argnames=("mode",))(
            jddpm.variables, jnp.asarray(x), jax.random.key(0), ts, mode="ddim"
        )
    got = ddpm.sample(2, 4, mode=mode, x_T=torch.from_numpy(x), data_format="NHWC")
    assert_chain_close(got, ref)
    # the diffusion-level chain is the same computation
    direct = ddpm.diffusion.sample_dpmpp(2, 4, x_T=torch.from_numpy(x)) if mode == "dpmpp_2m" else \
        ddpm.diffusion.sample(2, 4, mode="ddim", x_T=torch.from_numpy(x))
    np.testing.assert_array_equal(direct.numpy(), got.numpy())


@pytest.mark.parametrize("seed", [1, 6, 12])
@pytest.mark.parametrize("mode", ["dpmpp_2m", "ddim"])
def test_continuous_solvers_after_the_first_step_match_jax(families, mode, seed):
    """Both frameworks continue from the JAX state after the ill-conditioned
    t = 1 step (see assert_chain_close), so the remaining three steps are
    held to atol 1e-4 on several x_T, seed 6 among them."""
    jddpm, ddpm = families["continuous"]
    diff, key = jddpm.diffusion, jax.random.key(0)
    ts = jnp.linspace(1.0, 0.0, 5, dtype=jnp.float32)
    ts_rest = torch.from_numpy(np.array(ts[1:]))
    x = jnp.asarray(x_T(seed))
    if mode == "dpmpp_2m":
        so = ddpm.diffusion.dpmpp_second_order(4)
        seg = jax.jit(diff.dpmpp_2m_segment)
        x1, x0_1, lam_1, _ = seg(jddpm.variables, x, jnp.zeros(SHAPE), jnp.zeros((2, 1, 1, 1)), key, ts[:2],
                                 jnp.asarray(so[:1]))
        ref = seg(jddpm.variables, x1, x0_1, lam_1, key, ts[1:], jnp.asarray(so[1:]))[0]
        carry = [torch.from_numpy(np.array(a)) for a in (x1, x0_1, lam_1)]
        got = ddpm.diffusion.dpmpp_2m_segment(*carry, ts_rest, so[1:])[0]
    else:
        seg = jax.jit(diff.sample_segment, static_argnames=("mode",))
        x1, _ = seg(jddpm.variables, x, key, ts[:2], mode="ddim")
        ref, _ = seg(jddpm.variables, x1, key, ts[1:], mode="ddim")
        got = ddpm.diffusion.sample_segment(torch.from_numpy(np.array(x1)), ts_rest, mode="ddim")
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("mode, steps", [("euler", 4), ("midpoint", 2)])
def test_flow_ode_matches_jax(families, mode, steps):
    jddpm, ddpm = families["flow"]
    x = x_T(7)
    ts = jnp.linspace(1.0, 0.0, steps + 1, dtype=jnp.float32)
    ref, _ = jax.jit(jddpm.diffusion.sample_segment, static_argnames=("mode",))(
        jddpm.variables, jnp.asarray(x), jax.random.key(0), ts, mode=mode
    )
    got = ddpm.sample(2, steps, mode=mode, x_T=torch.from_numpy(x), data_format="NHWC")
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    q = ddpm.diffusion.q_step(torch.from_numpy(x), 0.7, 0.3, torch.from_numpy(x_T(8)))
    q_ref = jddpm.diffusion.q_step(jnp.asarray(x), 0.7, 0.3, jnp.asarray(x_T(8)))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), atol=1e-6)


# ------------------------------------------------------------------- RePaint
def jax_repaint_draws(key, known_shape, x_shape, T, r, j, flow):
    """The normals DDPM.repaint of the JAX package draws, in its order:
    x_T; per reverse sub-step the known noise and (Gaussian) the p-step
    noise; the forward-jump re-noise draws between resamples
    (diffusion/base.py:179-307, continuous.py:351-369, flow.py:102-124)."""
    draws = []
    key, sub = split_key(as_typed_key(key))
    draws.append(jax_normal(sub, x_shape))

    def reverse(key):
        for _ in range(j):
            key, k_known, k_p = split_key(key, 3)
            draws.append(jax_normal(k_known, known_shape))
            if not flow:
                draws.append(jax_normal(k_p, x_shape))
        return key

    def forward(key):
        for _ in range(j):
            key, sub = split_key(key)
            draws.append(jax_normal(sub, x_shape))
        return key

    for _ in range(T - 1):
        for jj in range(r):
            key = reverse(key)
            if jj != r - 1:
                key = forward(key)
    reverse(key)
    return [torch.from_numpy(np.array(d)) for d in draws]


@pytest.mark.parametrize("family", ["continuous", "flow"])
def test_repaint_matches_jax_with_replayed_keys(families, family):
    jddpm, ddpm = families[family]
    rng = np.random.default_rng(9)
    known = np.clip(rng.standard_normal(SHAPE), -1, 1).astype(np.float32)
    mask = np.zeros(SHAPE, np.float32)
    mask[0, ::4] = 1.0
    mask[1] = (rng.uniform(size=(16, 64, 1)) < 0.3)
    key = jax.random.key(11)
    ref = jddpm.repaint(jnp.asarray(known), jnp.asarray(mask), 3, num_resample_steps=2, jump_length=2, key=key,
                        data_format="NHWC")
    draws = jax_repaint_draws(key, SHAPE, SHAPE, 3, 2, 2, flow=family == "flow")
    # 5 reverse passes ((T-1) x r + 1) of j sub-steps, 2 x j re-noise draws
    assert len(draws) == 1 + 5 * 2 * (2 if family == "continuous" else 1) + 2 * 2
    it = iter(draws)
    got = ddpm.repaint(torch.from_numpy(known), torch.from_numpy(mask), 3, 2, 2, data_format="NHWC", noise=it)
    assert next(it, None) is None  # every draw used
    assert_chain_close(got, ref)
    # a callable source and the progress path take the same draws
    src = iter(draws)
    again = ddpm.repaint(torch.from_numpy(known), torch.from_numpy(mask), 3, 2, 2, data_format="NHWC",
                         noise=lambda shape: next(src), progress=True, progress_chunk=2)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_repaint_validation_matches_jax(families):
    known = np.zeros(SHAPE, np.float32)
    cases = [
        ("discrete", known, known),
        ("continuous", known, known[0]),  # unbatched mask
        ("continuous", np.zeros((3, 16, 64, 2), np.float32), known),  # mask batch 2 vs 3
    ]
    for family, kn, mk in cases:
        jddpm, ddpm = families[family]
        with pytest.raises(ValueError) as jerr:
            jddpm.repaint(jnp.asarray(kn), jnp.asarray(mk), 2, data_format="NHWC")
        with pytest.raises(ValueError) as err:
            ddpm.repaint(torch.from_numpy(kn), torch.from_numpy(mk), 2, data_format="NHWC")
        assert str(err.value) == str(jerr.value)
    ddpm = families["continuous"][1]
    for grid in ((0, 1, 1), (2, 0, 1), (2, 1, 0)):  # the JAX package asserts these
        with pytest.raises(ValueError, match="RePaint needs"):
            ddpm.repaint(torch.from_numpy(known), torch.from_numpy(known), *grid, data_format="NHWC")


# --------------------------------------------------------------- DDPM surface
def test_mode_and_family_errors_match_jax(families):
    """Each family and mode: the JAX DDPM.sample checks the mode first and
    the batch chunk next, so batch_chunk=0 makes both raise without
    sampling; the messages are the same."""
    raised = 0
    for family, (jddpm, ddpm) in families.items():
        for mode in ("ddpm", "ddim", "dpmpp_2m", "euler", "midpoint"):
            with pytest.raises(ValueError) as jerr:
                jddpm.sample(1, 1, mode=mode, batch_chunk=0)
            with pytest.raises(ValueError) as err:
                ddpm.sample(1, 1, mode=mode, batch_chunk=0)
            assert str(err.value) == str(jerr.value), (family, mode)
            raised += "batch_chunk" not in str(err.value)
    assert raised == 8  # continuous: euler, midpoint; discrete: those and dpmpp_2m; flow: three


def test_progress_and_return_all_do_not_change_samples(families, capsys):
    for family, mode in (("continuous", "ddpm"), ("continuous", "dpmpp_2m"), ("discrete", "ddpm"), ("flow", "euler")):
        ddpm = families[family][1]
        a = ddpm.sample(2, 3, seeds=[1, 2], mode=mode)
        b = ddpm.sample(2, 3, seeds=[1, 2], mode=mode, progress=True, progress_chunk=2)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        xs = ddpm.sample(2, 3, seeds=[1, 2], mode=mode, return_all=True, progress=True, progress_chunk=1)
        assert xs.shape == (4, 2, 2, 16, 64)
        np.testing.assert_array_equal(xs[-1].numpy(), a.numpy())
        x0 = torch.stack([torch.randn((16, 64, 2), generator=g) for g in setup_rng([1, 2], "cpu")])
        np.testing.assert_array_equal(xs[0].numpy(), x0.permute(0, 3, 1, 2).numpy())
        nhwc = ddpm.sample(2, 3, seeds=[1, 2], mode=mode, return_all=True, data_format="NHWC")
        np.testing.assert_array_equal(nhwc.numpy(), xs.permute(0, 1, 3, 4, 2).numpy())
    err = capsys.readouterr().err
    assert "sampling 3/3 steps" in err and "sampling 1/3 steps" in err


def test_batch_auto_chunking(families, monkeypatch):
    ddpm = families["continuous"][1]
    a = ddpm.sample(3, 2, seeds=[7, 8, 9])
    a_all = ddpm.sample(3, 2, seeds=[7, 8, 9], return_all=True)
    monkeypatch.setattr(DDPM, "MAX_BATCH_PIXELS", 2 * 16 * 64)  # two images a chunk
    b = ddpm.sample(3, 2, seeds=[7, 8, 9])
    b_all = ddpm.sample(3, 2, seeds=[7, 8, 9], return_all=True)
    # same draws per row; the CPU conv picks batch-size-dependent algorithms
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3)
    np.testing.assert_allclose(a_all.numpy(), b_all.numpy(), atol=2e-3)
    with pytest.warns(UserWarning, match="auto-chunking"):
        ddpm.sample(3, 1)
    known = torch.zeros(3, 2, 16, 64)
    mask = torch.zeros(1, 2, 16, 64)
    mask[:, :, :4] = 1.0
    r = ddpm.repaint(known, mask, 2, seeds=[1, 2, 3])
    monkeypatch.setattr(DDPM, "MAX_BATCH_PIXELS", 3 * 16 * 64)
    np.testing.assert_allclose(r.numpy(), ddpm.repaint(known, mask, 2, seeds=[1, 2, 3]).numpy(), atol=2e-3)
    with pytest.raises(ValueError, match="progress_chunk"):
        ddpm.sample(1, 1, progress_chunk=0)


def test_pretrained_lookup_in_the_cache_dir(variables, tmp_path, monkeypatch):
    monkeypatch.delenv("R2DM_CKPT_DIR", raising=False)
    monkeypatch.setenv("R2DM_CACHE_DIR", str(tmp_path))
    # a fetch that fails with no network traffic
    monkeypatch.setenv("R2DM_WEIGHTS_URL_BASE", (tmp_path / "no-release").as_uri())
    with pytest.raises(FileNotFoundError, match="R2DM_CKPT_DIR"):
        pretrained_r2dm("r2dm-h-kittiraw-300k", device="cpu")
    (tmp_path / "checkpoints").mkdir(exist_ok=True)  # the failed fetch made it
    ckpt = {"cfg": asdict(tiny_cfg()), "weights": {k: torch.from_numpy(np.array(v))
                                                   for k, v in export_unet_state_dict(variables).items()}}
    torch.save(ckpt, tmp_path / "checkpoints" / "r2dm-h-kittiraw-300k.pth")
    ddpm, _, cfg = pretrained_r2dm("r2dm-h-kittiraw-300k", ema=False, device="cpu")
    assert cfg.data.resolution == (16, 64) and ddpm.sampling_shape == (16, 64, 2)
    gens = setup_rng([3, 4], "cpu")
    assert len(gens) == 2 and torch.equal(torch.randn(2, generator=gens[0]), torch.randn(2, generator=setup_rng([3], "cpu")[0]))
