"""The port's spans and counters (``r2dm_tpu_torch/utils/trace.py``) on the
CPU: off records nothing; the records' parent, request and thread fields;
reset and snapshot; the spans each layer opens (one ``sampler.step`` a
denoising step with one ``network.forward`` under it, the train step's
phases in order, set-up's children, the loader's counters and its thread's
span, the width collectives'); the always-on kernel counters in the same
view; ``gaps``. One card-only test checks that a device span's start waits
behind work queued on the stream.

This file imports no JAX, so on a machine with the card it runs as
``python -m pytest --noconftest -m cuda tests/test_torch_port_trace.py``.
"""

import itertools
import json
import sys
import threading
import time
import types
from dataclasses import asdict

import pytest
import torch

from r2dm_tpu_torch import DDPM, config, ops, setup_model
from r2dm_tpu_torch import train as train_mod
from r2dm_tpu_torch.data import DataLoader, SyntheticLiDAR
from r2dm_tpu_torch.diffusion.base import normal
from r2dm_tpu_torch.inference import build_diffusion, build_model
from r2dm_tpu_torch.ops import fused_resample
from r2dm_tpu_torch.parallel import World
from r2dm_tpu_torch.parallel.width import all_reduce_sum_
from r2dm_tpu_torch.sample_and_save import postprocess
from r2dm_tpu_torch.training import EMAConfig, init_train_state, make_optimizer, make_train_step
from r2dm_tpu_torch.utils import trace

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _cfg(timestep_type="continuous", architecture="efficient_unet") -> config.Config:
    cfg = config.Config(
        data=config.DataConfig(dataset="synthetic", resolution=(16, 64), projection="spherical-256"),
        model=config.ModelConfig(architecture=architecture, base_channels=8, channel_multiplier=(1, 2, 2, 2),
                                 num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2),
    )
    cfg.diffusion.timestep_type = timestep_type
    return cfg


def _ddpm(timestep_type="continuous", architecture="efficient_unet") -> DDPM:
    cfg = _cfg(timestep_type, architecture)
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return DDPM(build_diffusion(cfg, model), cfg)


def _named(snap, name):
    return [i for i, s in enumerate(snap["spans"]) if s["name"] == name]


def _children(snap, i):
    return [j for j, s in enumerate(snap["spans"]) if s["parent"] == i]


def test_off_records_nothing_and_span_is_the_shared_noop():
    assert not trace.on()
    assert trace.span("sampler.step") is trace.span("network.forward", device=torch.zeros(1), request=True)
    ddpm = _ddpm()
    ddpm.sample(1, 2, mode="ddim", seeds=[0])
    trace.count("data.gets")
    snap = trace.snapshot()
    assert snap["spans"] == []
    assert not [k for k in snap["counters"] if not k.startswith("ops.")]


def test_records_parent_request_thread_and_self_time():
    trace.enable()
    with trace.span("entry.sample", request=True):
        with trace.span("sampler.step"):
            with trace.span("network.forward"):
                time.sleep(0.01)
        with trace.span("sampler.step"):
            pass
    with trace.span("entry.sample", request=True):
        pass
    worker = threading.Thread(target=lambda: trace.span("data.make_batch").__enter__().__exit__(None, None, None),
                              name="loader")
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    snap = trace.snapshot()
    spans = snap["spans"]
    assert [s["name"] for s in spans] == ["entry.sample", "sampler.step", "network.forward", "sampler.step",
                                          "entry.sample", "data.make_batch"]
    assert [s["parent"] for s in spans] == [None, 0, 1, 0, None, None]
    first, second = spans[0]["request"], spans[4]["request"]
    assert first is not None and second is not None and first != second
    assert [s["request"] for s in spans[:4]] == [first] * 4
    assert spans[5]["request"] is None and spans[5]["thread"] == "loader"
    assert {s["thread"] for s in spans[:5]} == {threading.current_thread().name}
    for s in spans:
        assert s["t0"] <= s["t1"] and s["d0"] is None and s["d1"] is None
        if s["parent"] is not None:
            assert spans[s["parent"]]["t0"] <= s["t0"] and s["t1"] <= spans[s["parent"]]["t1"]
    step = spans[1]
    assert trace.self_time(snap, 1) == pytest.approx((step["t1"] - step["t0"]) - (spans[2]["t1"] - spans[2]["t0"]))
    assert trace.self_time(snap, 2) == pytest.approx(spans[2]["t1"] - spans[2]["t0"])
    assert spans[2]["t1"] - spans[2]["t0"] >= 0.01
    assert trace.total(snap, "sampler.step") == pytest.approx(sum(s["t1"] - s["t0"] for s in (spans[1], spans[3])))


def test_reset_and_snapshot():
    trace.enable()
    with trace.span("entry.points"):
        pass
    trace.count("data.gets", 3)
    outer = trace.span("entry.sample", request=True)
    outer.__enter__()
    with trace.span("sampler.step"):
        pass
    snap = trace.snapshot()
    # spans still open are left out, and a child's parent then reads None
    assert [s["name"] for s in snap["spans"]] == ["entry.points", "sampler.step"]
    assert snap["spans"][1]["parent"] is None and snap["spans"][1]["request"] is not None
    assert snap["counters"]["data.gets"] == 3
    outer.__exit__(None, None, None)
    assert [s["name"] for s in trace.snapshot()["spans"]] == ["entry.points", "entry.sample", "sampler.step"]
    trace.reset()
    snap = trace.snapshot()
    assert snap["spans"] == [] and "data.gets" not in snap["counters"]
    trace.disable()
    with trace.span("entry.points"):
        pass
    assert trace.snapshot()["spans"] == []


@pytest.mark.parametrize("timestep_type,mode", [("continuous", "ddim"), ("continuous", "ddpm"),
                                                ("continuous", "dpmpp_2m"), ("discrete", "ddpm"), ("flow", "euler")])
def test_sample_gives_a_step_span_a_step_each_with_one_forward(timestep_type, mode):
    ddpm = _ddpm(timestep_type)
    steps = 4
    trace.enable()
    ddpm.sample(2, steps, mode=mode, seeds=[1, 2])
    snap = trace.snapshot()
    root, = _named(snap, "entry.sample")
    assert snap["spans"][root]["parent"] is None
    step_ids = _named(snap, "sampler.step")
    assert len(step_ids) == steps
    request = snap["spans"][root]["request"]
    for i in step_ids:
        assert snap["spans"][i]["parent"] == root and snap["spans"][i]["request"] == request
        kids = _children(snap, i)
        assert [snap["spans"][j]["name"] for j in kids] == ["network.forward"]
        assert snap["spans"][kids[0]]["request"] == request
    assert len(_named(snap, "network.forward")) == steps


def test_repaint_gives_a_step_span_an_outer_step():
    ddpm = _ddpm()
    known = torch.zeros((2, 2, 16, 64))
    mask = torch.zeros((1, 2, 16, 64))
    mask[..., :8] = 1.0
    trace.enable()
    ddpm.repaint(known, mask, num_steps=3, num_resample_steps=2, seeds=[1, 2])
    snap = trace.snapshot()
    root, = _named(snap, "entry.sample")
    steps = _named(snap, "sampler.step")
    assert len(steps) == 3 and all(snap["spans"][i]["parent"] == root for i in steps)
    # two resamples an outer step but the last, one forward a resample
    assert [len(_children(snap, i)) for i in steps] == [2, 2, 1]


def test_setup_model_and_points_spans():
    cfg = _cfg()
    model = build_model(cfg, device="cpu")
    trace.enable()
    ddpm, lidar_utils, _ = setup_model({"cfg": asdict(cfg), "ema_weights": model.state_dict()}, device="cpu")
    x = ddpm.sample(1, 1, mode="ddim", seeds=[0])
    postprocess(x, lidar_utils)
    snap = trace.snapshot()
    root, = _named(snap, "entry.setup_model")
    assert [snap["spans"][j]["name"] for j in _children(snap, root)] == ["entry.build", "entry.load_weights",
                                                                         "entry.to_device"]
    points, = _named(snap, "entry.points")
    assert snap["spans"][points]["parent"] is None and snap["spans"][points]["request"] is None


@pytest.mark.parametrize("kind", ["plain", "accumulate", "grad_bf16"])
def test_train_step_phases_in_order(kind):
    cfg = _cfg()
    model = build_model(cfg, device="cpu")
    diffusion = build_diffusion(cfg, model)
    optimizer, scheduler = make_optimizer(model.parameters(), cfg.training)
    state = init_train_state(model, optimizer, scheduler, 2 if kind == "accumulate" else 1)
    train_step = make_train_step(diffusion, optimizer, scheduler, EMAConfig(),
                                 grad_dtype=torch.bfloat16 if kind == "grad_bf16" else None)
    g = torch.Generator().manual_seed(0)
    x_0 = normal(g, (2, 16, 64, 2), "cpu").clamp(-1, 1)
    trace.enable()
    for _ in range(2):
        train_step(state, x_0, g)
    snap = trace.snapshot()
    steps = _named(snap, "train.step")
    assert len(steps) == 2
    for i in steps:
        kids = _children(snap, i)
        assert [snap["spans"][j]["name"] for j in kids] == ["train.loss", "train.backward", "train.update"]
        t = [snap["spans"][j] for j in kids]
        assert t[0]["t1"] <= t[1]["t0"] and t[1]["t1"] <= t[2]["t0"]
        assert [snap["spans"][j]["name"] for j in _children(snap, kids[0])] == ["network.forward"]


def test_loader_counts_its_gets_and_traces_its_thread():
    loader = DataLoader(SyntheticLiDAR(num_scans=6, projection="spherical-256"), 2, seed=3)
    trace.enable()
    it = iter(loader)
    try:
        for _ in range(5):
            next(it)
    finally:
        it.close()
    snap = trace.snapshot()
    c = snap["counters"]
    assert c["data.gets"] == 5 and 0 <= c["data.gets_empty"] <= 5
    made = [snap["spans"][i] for i in _named(snap, "data.make_batch")]
    assert len(made) >= 5
    assert all(s["parent"] is None and s["thread"] != threading.current_thread().name for s in made)


def test_counters_report_the_kernel_wrappers_and_the_world():
    ops.reset_launch_counts()
    try:
        for k, fn in enumerate(ops.KERNEL_WRAPPERS):
            fn.launches = k + 1
        fused_resample.conv_then_downsample.calls = 7
        counters = trace.snapshot(World(collective_calls=5))["counters"]
        for k, fn in enumerate(ops.KERNEL_WRAPPERS):
            assert counters[f"ops.{fn.__name__}.launches"] == k + 1
        assert counters["ops.conv_then_downsample.calls"] == 7
        assert counters["ops.upsample_then_conv.calls"] == fused_resample.upsample_then_conv.calls
        assert counters["parallel.collective_calls"] == 5
        assert "parallel.collective_calls" not in trace.snapshot()["counters"]
    finally:
        ops.reset_launch_counts()
        fused_resample.conv_then_downsample.calls = 0


def test_counters_report_the_ring_conv_by_tile_variant():
    """Beside ``ops.<wrapper>.launches``, the ring conv's two wrappers are
    reported by tile variant, ``ops.<wrapper>.launches.<variant>``, and
    ``reset_launch_counts`` zeroes those too."""
    from r2dm_tpu_torch.ops import act_ringconv

    ops.reset_launch_counts()
    try:
        for fn in (act_ringconv.fused_act_ringconv, act_ringconv.act_ringconv_halo):
            for k, tile in enumerate(act_ringconv.TILES):
                fn.tile_launches[tile] = k + 1
        counters = trace.snapshot()["counters"]
        for name in ("fused_act_ringconv", "act_ringconv_halo"):
            assert [counters[f"ops.{name}.launches.{tile}"] for tile in act_ringconv.TILES] == \
                list(range(1, len(act_ringconv.TILES) + 1))
        ops.reset_launch_counts()
        counters = trace.snapshot()["counters"]
        assert not any(v for k, v in counters.items() if k.startswith("ops.") and ".launches." in k)
    finally:
        ops.reset_launch_counts()


def test_a_width_collective_is_a_span_and_a_count(tmp_path):
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        world = World(distributed=True, width_size=2, width_group=dist.group.WORLD)
        t = torch.ones(3)
        all_reduce_sum_(t, world)
        assert world.collective_calls == 1 and trace.snapshot()["spans"] == []
        trace.enable()
        all_reduce_sum_(t, world)
        snap = trace.snapshot(world)
        assert [s["name"] for s in snap["spans"]] == ["parallel.collective"]
        assert snap["counters"]["parallel.collective_calls"] == 2
        assert not hasattr(world, "collective_seconds")
    finally:
        dist.destroy_process_group()


def test_gaps_name_the_host_span_the_device_waited_on():
    def s(name, t0, t1, parent=None, d=None):
        return {"name": name, "t0": t0, "t1": t1, "parent": parent, "thread": "main", "request": 1,
                "d0": d[0] if d else None, "d1": d[1] if d else None}

    snap = {"spans": [
        s("entry.sample", 0.0, 10.0, d=(0.1, 10.0)),
        s("sampler.step", 0.0, 2.0, 0, d=(0.1, 3.0)),
        s("network.forward", 0.5, 2.0, 1),
        s("sampler.step", 2.0, 4.0, 0, d=(3.0, 5.0)),       # queued behind the first: no gap
        s("sampler.step", 4.0, 8.0, 0, d=(6.5, 7.0)),
        s("network.forward", 4.5, 6.4, 4),                   # the device went idle at 5.0 inside it
        s("sampler.step", 8.0, 9.0, 0, d=(8.0, 9.0)),        # idle from 7.0, inside the third step's self time
    ], "counters": {}}
    got = trace.gaps(snap, "sampler.step")
    assert [(g["start"], g["label"]) for g in got] == [(5.0, "network.forward"), (7.0, "sampler.step")]
    assert [g["seconds"] for g in got] == pytest.approx([1.5, 1.0])
    assert trace.gaps(snap, ("sampler.step", "entry.sample")) == []
    snap["spans"][5]["thread"] = "other"
    assert trace.gaps(snap, "sampler.step")[0]["label"] == "sampler.step"


def test_train_cli_traces_its_profiled_steps_and_rates_the_last_interval(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the JSONL sink alone
    monkeypatch.setenv("R2DM_SYNTH_SCANS", "8")
    clock = itertools.count()  # the trainer's clock reads 0, 1, 2, ...
    monkeypatch.setattr(train_mod, "time", types.SimpleNamespace(time=lambda: float(next(clock))))
    out, prof = tmp_path / "run", tmp_path / "profile"
    assert train_mod.main([
        "--device", "cpu", "--data.dataset", "synthetic", "--data.projection", "spherical-256",
        "--data.resolution", "16,64", "--model.base_channels", "8", "--model.channel_multiplier", "1,2,2,2",
        "--model.num_residual_blocks", "1,1,1,1", "--model.gn_num_groups", "4", "--model.attn_num_heads", "2",
        "--model.coords_encoding", "None", "--training.batch_size_train", "2", "--training.batch_size_eval", "2",
        "--training.lr_warmup_steps", "2", "--training.mixed_precision", "no", "--training.num_steps", "50",
        "--training.steps_save_image", "1000", "--training.output_dir", str(out),
        "--training.profile_dir", str(prof)]) == 0
    lines = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    # start 0; step 1 logged at 1, its step ended at 2; step 50 logged at 3
    assert [(r["step"], r["steps_per_sec"]) for r in lines] == [(1, 1.0), (50, 49.0)]
    names = [e["name"] for e in json.loads((prof / "trace.json").read_text())["traceEvents"]]
    for span in ("train.step", "train.loss", "train.backward", "train.update", "network.forward"):
        assert names.count(span) == 5, span
    assert not trace.on()


@pytest.mark.cuda
def test_a_device_span_waits_behind_queued_work():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    trace.enable()
    with trace.span("sampler.step", device=x):
        x.add_(1)
    torch.cuda._sleep(300_000_000)  # 3e8 cycles, 0.15-0.3 s queued ahead of the next span
    with trace.span("sampler.step", device=x):
        x.add_(1)
    snap = trace.snapshot()
    idle, busy = snap["spans"]
    for s in (idle, busy):
        assert s["d0"] <= s["d1"]
    assert -2e-3 < idle["d0"] - idle["t0"] < 5e-3
    assert busy["d0"] - busy["t0"] > 0.05
    assert busy["d0"] >= idle["d1"]
