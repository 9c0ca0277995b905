"""The port's last serving gaps against the JAX package, on the CPU: the
by-name checkpoint fetch (``resolve_pretrained_ckpt``, through a
``file://`` base in the test's directory, so no network), the default
download cache, sampling without seeds across two gloo ranks, the hub
aliases (``r2dm_tpu_torch.hub``), ``DDPM.loss`` and ``DDPM.coords``, and the
``.pth`` exporter against ``tools/export_torch_ckpt.py``."""

import copy
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_port_parallel import run as run_ranks

from r2dm_tpu import checkpoint as jax_checkpoint
from r2dm_tpu import setup_model as jax_setup_model
from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch import export_torch_ckpt, hub
from r2dm_tpu_torch.inference import build_model, model_coords, pretrained_r2dm, resolve_pretrained_ckpt
from r2dm_tpu_torch.inference import setup_model
from r2dm_tpu_torch.metrics.extractor import postprocess, rangenet
from r2dm_tpu_torch.utils.weights import to_jax

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIG = "r2dm-test"


def _cfg(architecture="efficient_unet") -> port_config.Config:
    return port_config.Config(
        data=port_config.DataConfig(dataset="synthetic", resolution=(16, 64), projection="spherical-256"),
        model=port_config.ModelConfig(architecture=architecture, base_channels=8, channel_multiplier=(1, 2, 2, 2),
                                      num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2),
    )


def _random_state(cfg, seed) -> dict:
    """The port network's state_dict, every parameter ~ N(0, 0.05^2) from
    ``seed`` and the sensor's coordinates (an EfficientUNet)."""
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        if cfg.model.architecture == "efficient_unet":
            model.coords.copy_(torch.from_numpy(model_coords(cfg).transpose(2, 0, 1)[None].copy()))
    return model.state_dict()


@pytest.fixture(scope="module")
def tiny_pth(tmp_path_factory) -> str:
    """A reference-layout .pth of the tiny EfficientUNet."""
    cfg = _cfg()
    sd = _random_state(cfg, 0)
    path = tmp_path_factory.mktemp("pth") / f"{CONFIG}.pth"
    torch.save({"cfg": port_config.asdict(cfg), "weights": {f"model.{k}": v for k, v in sd.items()},
                "global_step": 1}, path)
    return str(path)


# --------------------------------------------------------- the fetch, cache
def _no_env(monkeypatch):
    for var in ("R2DM_CKPT_DIR", "R2DM_CACHE_DIR", "R2DM_WEIGHTS_URL_BASE"):
        monkeypatch.delenv(var, raising=False)


def test_resolve_fetches_into_the_cache_then_hits_it(tmp_path, monkeypatch):
    """As tests/test_hub_api.py:32-57 holds the JAX package's: fetch
    <base>/<config>.pth into the cache, hit the cache with the source gone,
    and $R2DM_CKPT_DIR first."""
    _no_env(monkeypatch)
    release = tmp_path / "release"
    release.mkdir()
    (release / f"{CONFIG}.pth").write_bytes(b"fake-weights")
    monkeypatch.setenv("R2DM_WEIGHTS_URL_BASE", release.as_uri())
    monkeypatch.setenv("R2DM_CACHE_DIR", str(tmp_path / "cache"))
    path = resolve_pretrained_ckpt(CONFIG, progress=False)
    assert path == str(tmp_path / "cache" / "checkpoints" / f"{CONFIG}.pth")
    assert Path(path).read_bytes() == b"fake-weights"
    assert not Path(path + ".tmp").exists()
    (release / f"{CONFIG}.pth").unlink()
    assert resolve_pretrained_ckpt(CONFIG, progress=False) == path
    local = tmp_path / "local"
    local.mkdir()
    (local / f"{CONFIG}.pth").write_bytes(b"local-weights")
    monkeypatch.setenv("R2DM_CKPT_DIR", str(local))
    assert Path(resolve_pretrained_ckpt(CONFIG, progress=False)).read_bytes() == b"local-weights"


def test_a_failed_fetch_leaves_no_tmp_and_names_both_remedies(tmp_path, monkeypatch):
    _no_env(monkeypatch)
    monkeypatch.setenv("R2DM_WEIGHTS_URL_BASE", (tmp_path / "missing").as_uri())
    monkeypatch.setenv("R2DM_CACHE_DIR", str(tmp_path / "cache"))
    with pytest.raises(FileNotFoundError, match="R2DM_CKPT_DIR") as err:
        resolve_pretrained_ckpt(CONFIG, progress=False)
    assert "ckpt_path=" in str(err.value) and CONFIG in str(err.value)
    assert not (tmp_path / "cache" / "checkpoints" / f"{CONFIG}.pth.tmp").exists()
    assert not (tmp_path / "cache" / "checkpoints" / f"{CONFIG}.pth").exists()


def test_pretrained_r2dm_reads_the_default_cache(tiny_pth, tmp_path, monkeypatch):
    """With $R2DM_CACHE_DIR unset the cache is ~/.cache/r2dm_tpu, where the
    JAX package downloads to (r2dm_tpu/inference.py:874-879)."""
    _no_env(monkeypatch)
    monkeypatch.setenv("R2DM_WEIGHTS_URL_BASE", (tmp_path / "missing").as_uri())
    monkeypatch.setenv("HOME", str(tmp_path))
    cached = tmp_path / ".cache" / "r2dm_tpu" / "checkpoints" / f"{CONFIG}.pth"
    cached.parent.mkdir(parents=True)
    cached.write_bytes(Path(tiny_pth).read_bytes())
    ddpm, _, cfg = pretrained_r2dm(CONFIG, ema=False, device="cpu")
    ref, _, _ = setup_model(tiny_pth, ema=False, device="cpu")
    assert cfg.data.resolution == (16, 64)
    for (k, v), (_, w) in zip(ddpm.model.state_dict().items(), ref.model.state_dict().items()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)


# ------------------------------------------------ sampling across ranks
SAMPLE_ON_A_RANK = r'''
import torch
from r2dm_tpu_torch import setup_model

ddpm, _, _ = setup_model(CKPT, device="cpu")
try:
    ddpm.sample(1, 1)
    print("no error")
except ValueError as e:
    print("ValueError:", e)
x = ddpm.sample(2, 1, seeds=[3, 4])
print("seeded", repr(float(x.double().abs().sum())))
'''


def test_two_ranks_without_seeds_raise_and_with_seeds_run(tiny_pth, tmp_path):
    """Without seeds every rank would draw the same batch: each of two gloo
    ranks raises JAX's ValueError (r2dm_tpu/inference.py:207-211); with
    seeds both sample, and the same seeds give the same samples."""
    code = SAMPLE_ON_A_RANK.replace("CKPT", repr(tiny_pth))
    outs = run_ranks(tmp_path, "-c", [[code], [code]])
    seeded = []
    for out in outs:
        assert "ValueError: multi-host sampling needs an explicit key= or seeds=" in out, out[-2000:]
        seeded.append(next(line for line in out.splitlines() if line.startswith("seeded")))
    assert seeded[0] == seeded[1]
    one = run_ranks(tmp_path, "-c", [[code]])[0]
    assert "no error" in one and next(line for line in one.splitlines() if line.startswith("seeded")) == seeded[0]


# ------------------------------------------------------------ hub aliases
def test_hub_aliases_build_what_the_direct_calls_build():
    assert hub.pretrained_r2dm is pretrained_r2dm and hub.setup_model is setup_model
    for backbone, direct in ((21, rangenet.rangenet21), (53, rangenet.rangenet53)):
        torch.manual_seed(0)
        net, pre = hub.rangenet(None, backbone=backbone, device="cpu")
        torch.manual_seed(0)
        ref, ref_pre = direct(None, device="cpu")
        assert type(net) is type(ref) and pre.func is ref_pre.func
        sd, ref_sd = net.state_dict(), ref.state_dict()
        assert list(sd) == list(ref_sd)
        for k in sd:
            torch.testing.assert_close(sd[k], ref_sd[k], rtol=0, atol=0, msg=k)
    rng = np.random.default_rng(0)
    depth = torch.from_numpy(rng.uniform(-0.5, 5.0, (2, 1, 8, 16)).astype(np.float32))
    label = torch.from_numpy(rng.integers(0, 20, (2, 8, 16)))
    knn = hub.knn(20, k=5)
    torch.testing.assert_close(knn(depth, label), postprocess.knn_filter(depth, label, num_classes=20, k=5))
    crf = hub.crf_rnn(4, device="cpu", num_iters=2)
    ref = postprocess.CRFRNN(4, num_iters=2, device="cpu")
    unary = torch.from_numpy(rng.standard_normal((1, 4, 8, 16)).astype(np.float32))
    xyz = torch.from_numpy(rng.standard_normal((1, 3, 8, 16)).astype(np.float32))
    mask = torch.ones(1, 8, 16)
    assert isinstance(crf, postprocess.CRFRNN)
    torch.testing.assert_close(crf(unary, xyz, mask), ref(unary, xyz, mask), rtol=0, atol=0)


# ------------------------------------------------------- DDPM.loss, coords
def test_ddpm_loss_and_coords(tiny_pth):
    ddpm, _, _ = setup_model(tiny_pth, ema=False, device="cpu")
    x_0 = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 16, 64, 2)).astype(np.float32))
    with torch.no_grad():
        loss = ddpm.loss(x_0, generator=torch.Generator().manual_seed(5))
        ref = ddpm.diffusion.loss(ddpm.model, x_0, torch.Generator().manual_seed(5))
        nchw = ddpm.loss(x_0.permute(0, 3, 1, 2), generator=torch.Generator().manual_seed(5), data_format="NCHW")
        other = ddpm.loss(x_0, generator=torch.Generator().manual_seed(6))
    assert loss.dim() == 0 and float(loss) > 0
    assert torch.equal(loss, ref) and torch.equal(nchw, loss) and not torch.equal(other, loss)
    jddpm, _, _ = jax_setup_model(tiny_pth, ema=False)
    want = np.asarray(jddpm.coords)
    assert want.shape == (16, 64, 2)
    np.testing.assert_array_equal(ddpm.coords.numpy(), want)


# -------------------------------------------------------------- exporter
def _tool_main():
    spec = importlib.util.spec_from_file_location("export_tool", REPO / "tools" / "export_torch_ckpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("architecture", ["efficient_unet", "refinenet"])
def test_exporter_writes_what_the_jax_tool_writes(architecture, tmp_path, monkeypatch, capsys):
    """One msgpack (weights and a different EMA lane), exported by the port
    and by tools/export_torch_ckpt.py: the same cfg, step and key sets, and
    every tensor bit for bit in both lanes; the port's .pth then loads
    through setup_model and gives the msgpack's forward."""
    cfg = _cfg(architecture)
    weights, ema = (to_jax(_random_state(cfg, s), architecture) for s in (1, 2))
    pack = tmp_path / "ckpt.msgpack"
    jax_checkpoint.save_checkpoint(str(pack), port_config.asdict(cfg), weights, ema_weights=ema, step=7)
    monkeypatch.chdir(REPO)
    _tool_main()([str(pack), str(tmp_path / "tool.pth")])
    assert export_torch_ckpt.main([str(pack), str(tmp_path / "port.pth")]) == 0
    assert "tensors/lane, step 7" in capsys.readouterr().out
    got = torch.load(tmp_path / "port.pth", weights_only=False)
    want = torch.load(tmp_path / "tool.pth", weights_only=False)
    assert got["cfg"] == want["cfg"] and got["global_step"] == want["global_step"] == 7
    for lane in ("weights", "ema_weights"):
        assert set(got[lane]) == set(want[lane]) and "model.coords" in want[lane]
        for k, v in want[lane].items():
            assert got[lane][k].dtype == v.dtype and torch.equal(got[lane][k], v), (lane, k)
    assert any(not torch.equal(v, got["ema_weights"][k]) for k, v in got["weights"].items())
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 16, 64, 2)).astype(np.float32))
    cond = torch.tensor([0.7])
    outs = []
    for path in (tmp_path / "port.pth", pack):
        ddpm, _, _ = setup_model(str(path), device="cpu")
        with torch.no_grad():
            outs.append(ddpm.model(x, cond))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert float(outs[0].abs().max()) > 1e-3


# ------------------------------------------------- bench: flow euler-1 line
def test_bench_flow_euler1_secondary_headline(monkeypatch):
    """The one-step flow line (bench.py:364-399) on a tiny network on the
    CPU, its chains timed on the host's clock in place of CUDA events: 2
    trials, finite img/s, the sanity check on an untimed call first; ranks'
    lines sum it as they sum the headline."""
    import time

    from r2dm_tpu_torch import bench

    calls = []

    def counted(ddpm, batch, steps, mode, seed, world=None):
        calls.append((type(ddpm.diffusion).__name__, batch, steps, mode))
        x_T = torch.randn((batch, *ddpm.sampling_shape), generator=torch.Generator().manual_seed(seed))
        t0 = time.perf_counter()
        x = ddpm.sample(batch, steps, mode=mode, data_format="NHWC", x_T=x_T)
        return time.perf_counter() - t0, x

    monkeypatch.setattr(bench, "_timed", counted)
    monkeypatch.delenv("R2DM_TPU_INT8", raising=False)
    small = _cfg()
    # the flow lane's default Config, cut to size
    monkeypatch.setattr(bench.config_lib, "Config", lambda: copy.deepcopy(small))
    out = bench._flow_euler1(bench.random_ddpm("cpu", cfg=copy.deepcopy(small)), 2)
    assert calls == [("RectifiedFlow", 2, 1, "euler")] * bench.FLOW_NET_CALLS
    assert out["flow_euler1_trials"] == 2 and np.isfinite(out["flow_euler1_img_per_s"])
    assert out["flow_euler1_img_per_s"] == pytest.approx(2 / out["flow_euler1_seconds_median"])
    r0 = {"value": 1.0, "mfu": 0.1, "mfu_all": 0.1, "flow_euler1_img_per_s": 3.0}
    assert bench.aggregate([r0, dict(r0)])["flow_euler1_img_per_s"] == 6.0
