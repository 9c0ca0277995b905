"""Rendering, the generate and bench entry points of the port, on the CPU:
the render goldens, the port's colour tables and PNG writer, the preview
panels against the repo's generate.py, ``python -m r2dm_tpu_torch.generate``
on a tiny JAX msgpack checkpoint, and the bench's FLOP count."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from matplotlib import cm
from matplotlib import image as mpimg

from r2dm_tpu.checkpoint import save_checkpoint
from r2dm_tpu.config import Config as JaxConfig
from r2dm_tpu.config import DataConfig, ModelConfig, asdict
from r2dm_tpu.inference import build_model as jax_build_model
from r2dm_tpu.inference import model_coords as jax_model_coords
from r2dm_tpu.lidar import LiDARUtility as JaxLiDARUtility
from r2dm_tpu_torch import bench, render
from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch import generate as port_generate
from r2dm_tpu_torch.colormaps import TURBO, VIRIDIS
from r2dm_tpu_torch.inference import build_model
from r2dm_tpu_torch.lidar import LiDARUtility

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = Path(__file__).parent / "golden"


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN / "render.npz")


def test_rasterizer_normals_and_extrinsics_match_goldens(g):
    out = render.bilinear_rasterizer(t(g["coords"]), t(g["values"]), (32, 32))
    np.testing.assert_allclose(out.numpy(), g["rast"].transpose(0, 2, 3, 1), rtol=1e-4, atol=1e-5)
    pts = t(g["pts"].transpose(0, 2, 3, 1))
    np.testing.assert_allclose(
        render.estimate_surface_normal(pts, d=2, mode="closest").numpy(),
        g["normals"].transpose(0, 2, 3, 1), rtol=1e-3, atol=1e-3,
    )
    np.testing.assert_allclose(
        render.estimate_surface_normal(pts, d=1, mode="mean").numpy(),
        g["normals_mean"].transpose(0, 2, 3, 1), rtol=1e-3, atol=1e-3,
    )
    R, tv = render.make_Rt(pitch=np.pi / 4, yaw=np.pi / 8, z=0.8)
    np.testing.assert_allclose(R.numpy(), g["R"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), g["t_vec"], atol=1e-7)


def test_render_point_clouds_and_colorize_match_goldens(g):
    bev = render.render_point_clouds(t(g["points_flat"]), t(g["colors"]), size=64, R=t(g["R"]), t=t(g["t_vec"]))
    np.testing.assert_allclose(bev.numpy(), g["bev"].transpose(0, 2, 3, 1), rtol=1e-3, atol=1e-3)
    out = render.colorize(t(g["scalar"]))
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), g["colorized"].transpose(0, 2, 3, 1))


def test_colour_tables_match_matplotlib():
    for table, cmap in ((TURBO, cm.turbo), (VIRIDIS, cm.viridis)):
        ref = np.asarray(cmap(np.linspace(0, 1, 256))[:, :3], np.float32)
        assert table.shape == (256, 3) and table.dtype == np.float32
        assert float(np.abs(table - ref).max()) <= 1 / 255


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_round_trips_through_matplotlib(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, size=(17, 33, channels), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    render.write_png(path, img[..., 0] if channels == 1 else img)
    back = mpimg.imread(path)
    np.testing.assert_array_equal(np.round(back * 255).astype(np.uint8).reshape(img.shape), img)
    with pytest.raises(TypeError):
        render.write_png(path, img.astype(np.float32))


def _root_generate():
    spec = importlib.util.spec_from_file_location("root_generate", REPO / "generate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_panels_match_the_repos_generate():
    """The same [0, 1] scans through the repo's generate.render_panels and
    the port's: equal to one uint8 level."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0.2, 0.9, size=(2, 16, 64, 2)).astype(np.float32)
    kw = dict(resolution=(16, 64), depth_format="log_depth", min_depth=1.45, max_depth=80.0, data_format="NHWC")
    img_ref, bev_ref = _root_generate().render_panels(jnp.asarray(x), JaxLiDARUtility(**kw))
    img, bev = port_generate.render_panels(torch.from_numpy(x), LiDARUtility(**kw))
    assert img.shape == (2, 32, 64, 3) and bev.shape == (2, 800, 800, 3)
    assert int(np.abs(img.astype(np.int16) - np.asarray(img_ref)).max()) <= 1
    assert int(np.abs(bev.astype(np.int16) - bev_ref).max()) <= 1
    assert bev.std() > 0  # the points landed in the view


@pytest.fixture(scope="module")
def tiny_msgpack(tmp_path_factory):
    cfg = JaxConfig(
        data=DataConfig(resolution=(16, 64)),
        model=ModelConfig(base_channels=8, channel_multiplier=(1, 2, 2, 2), num_residual_blocks=(1, 1, 1, 1),
                          gn_num_groups=4, attn_num_heads=2),
    )
    variables = jax_build_model(cfg).init(jax.random.key(0), jnp.zeros((1, 16, 64, 2)), jnp.zeros((1,)))
    variables = {**variables, "buffers": {"coords": jnp.asarray(jax_model_coords(cfg))}}
    path = tmp_path_factory.mktemp("ckpt") / "tiny.msgpack"
    save_checkpoint(str(path), asdict(cfg), variables, ema_weights=variables, step=1)
    return str(path)


@pytest.mark.parametrize("video", [False, True])
def test_generate_cli_writes_previews(tiny_msgpack, tmp_path, capsys, video):
    args = port_generate.parse_args([
        "--ckpt", tiny_msgpack, "--mode", "ddim", "--batch_size", "2", "--sampling_steps", "3",
        "--device", "cpu", "--out_dir", str(tmp_path), *(["--video"] if video else []),
    ])
    assert port_generate.main(args) == 0
    img = mpimg.imread(str(tmp_path / "samples_img.png"))
    bev = mpimg.imread(str(tmp_path / "samples_bev.png"))
    assert img.shape == (2 * 2 * 16, 64, 3) and bev.shape == (800, 1600, 3)
    frames = sorted((tmp_path / "samples_frames").glob("frame_*.png"))
    assert len(frames) == (4 if video else 0)  # x_T and the 3 steps
    assert "sampling 3/3 steps" in capsys.readouterr().err


def test_generate_cli_refuses_unported_lanes(tiny_msgpack, tmp_path):
    """No lane is refused any more: --latency_layout (the W2C layout, the
    same math on the NHWC kernels) runs, in process and as ``python -m``,
    and writes the PNGs of the run without it byte for byte; --int8 runs
    its lane (tests/test_torch_port_quant.py)."""
    run = ["--ckpt", tiny_msgpack, "--batch_size", "2", "--sampling_steps", "2", "--device", "cpu"]
    for name, extra in (("plain", []), ("w2c", ["--latency_layout"])):
        assert port_generate.main(port_generate.parse_args(run + extra + ["--out_dir", str(tmp_path / name)])) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "r2dm_tpu_torch.generate", *run, "--latency_layout", "--out_dir", str(tmp_path / "cli")],
        cwd=REPO, capture_output=True, text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    for png in ("samples_img.png", "samples_bev.png"):
        plain = (tmp_path / "plain" / png).read_bytes()
        assert (tmp_path / "w2c" / png).read_bytes() == plain and (tmp_path / "cli" / png).read_bytes() == plain


def test_bench_flop_count_of_config_h():
    """The convolutions of a config-H forward are bench.py's 229.4 GFLOP
    (XLA cost analysis) to 0.5 %; attention and the dense layers come on
    top."""
    flops = bench.forward_flops(build_model(port_config.Config(), device="cpu"))
    assert abs(bench.protocol_flops(flops) / 229.4e9 - 1) <= 0.005
    # two attention blocks at 8x128 tokens, d_block4's at 512 channels and
    # u_block4's at 256: projections 4 C^2 and the two products 2 N C a token
    n = 8 * 128
    assert flops["attention"] == sum(2 * n * (4 * c * c + 2 * n * c) for c in (512, 256))
    assert 234e9 < sum(flops.values()) < 236e9


def test_bench_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main(batch=1, steps=1, trials=1)
