"""Card-only tests of the serving paths: every sampler mode of every family,
and RePaint, run through both CUDA kernels (exact launches, read from the
kernels that ran on the card) on a tiny config-H-shaped net in bf16; and the
network's forward replayed as a CUDA graph (``models/forward_graph.py``)
against the eager forward, bit for bit.

They skip without a CUDA device. This file imports no JAX, so on a machine
with the card and without JAX it runs as
``python -m pytest --noconftest -m cuda tests/test_torch_port_serving_cuda.py``.
"""

import dataclasses

import pytest
import torch

from r2dm_tpu_torch import config as config_lib
from r2dm_tpu_torch import ops
from r2dm_tpu_torch.inference import DDPM, build_diffusion, build_model
from r2dm_tpu_torch.models import forward_graph, layers
from r2dm_tpu_torch.ops import act_ringconv, gn_silu
from r2dm_tpu_torch.utils import trace

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# per forward of the tiny net: 8 ResidualBlocks (2 norms, 2 convs each) and
# 2 attention norms
PER_FORWARD = {"fused_group_norm_silu": 18, "fused_act_ringconv": 16, "ring_conv_w8a8": 0, "act_absmax": 0,
               "act_quantize": 0, "act_ringconv_halo": 0, "gn_stats": 0, "gn_apply": 0,
               "act_quantize_halo": 0}


def _ddpm(timestep_type: str) -> DDPM:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    cfg = config_lib.Config(
        data=config_lib.DataConfig(resolution=(16, 64)),
        model=config_lib.ModelConfig(base_channels=16, gn_num_groups=4, attn_num_heads=4,
                                     num_residual_blocks=(1, 1, 1, 1)),
        diffusion=config_lib.DiffusionConfig(timestep_type=timestep_type),
    )
    model = build_model(cfg, dtype=torch.bfloat16, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return DDPM(build_diffusion(cfg, model.to("cuda")), cfg)


def _launched(fn):
    """fn() and the kernel wrappers' counts of their calls meanwhile."""
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {f.__name__: f.launches for f in ops.KERNEL_WRAPPERS}


def _ran(fn):
    """fn() and the hand-written kernels that ran on the card meanwhile, by
    the wrapper that launches them (``chip_smoke.device_launches``): a
    replayed forward runs them with no wrapper call."""
    import chip_smoke

    with chip_smoke.device_launches(torch) as ran:
        out = fn()
    return out, ran.counts


def _counted(fn):
    """fn() with the program's tracing on: (its result, the counters)."""
    trace.reset()
    trace.enable()
    try:
        out = fn()
        torch.cuda.synchronize()
        return out, trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()


def _eager(fn):
    """fn() with every forward over the pixel limit, so none replays a graph."""
    limit = forward_graph.MAX_GRAPH_PIXELS
    forward_graph.MAX_GRAPH_PIXELS = 0
    try:
        return fn()
    finally:
        forward_graph.MAX_GRAPH_PIXELS = limit


def _inputs(batch: int = 2):
    g = torch.Generator("cuda").manual_seed(3)
    return torch.randn((batch, 16, 64, 2), generator=g, device="cuda"), torch.rand((batch,), generator=g, device="cuda")


SAMPLERS = [
    ("continuous", "ddpm", 1), ("continuous", "ddim", 1), ("continuous", "dpmpp_2m", 1),
    ("discrete", "ddpm", 1), ("discrete", "ddim", 1), ("flow", "euler", 1), ("flow", "midpoint", 2),
]


@pytest.mark.parametrize("family,mode,forwards_per_step", SAMPLERS)
def test_every_sampler_runs_the_kernels(family, mode, forwards_per_step):
    ddpm = _ddpm(family)
    xs, ran = _ran(lambda: ddpm.sample(2, 3, seeds=[0, 1], mode=mode, return_all=True))
    assert ran == {k: v * 3 * forwards_per_step for k, v in PER_FORWARD.items()}
    assert xs.shape == (4, 2, 2, 16, 64) and xs.is_cuda and bool(torch.isfinite(xs).all())
    if family != "flow":  # the Gaussian samplers clip x_0
        assert xs[-1].abs().max().item() <= 1.02
    again = ddpm.sample(2, 3, seeds=[0, 1], mode=mode, progress=True, progress_chunk=2)
    assert torch.equal(again, xs[-1])


@pytest.mark.parametrize("family", ["continuous", "flow"])
def test_repaint_on_the_card_keeps_the_known_pixels(family):
    ddpm = _ddpm(family)
    known = torch.rand((2, 2, 16, 64), device="cuda") * 2 - 1
    mask = torch.zeros((2, 2, 16, 64), device="cuda")
    mask[:, :, ::4] = 1.0
    out, ran = _ran(lambda: ddpm.repaint(known, mask, 3, 2, 2, seeds=[0, 1]))
    # (T - 1) x r reverse passes and the final one, j sub-steps each
    assert ran == {k: v * 5 * 2 for k, v in PER_FORWARD.items()}
    assert bool(torch.isfinite(out).all())
    assert ((out - known).abs() * mask).max().item() <= 1e-2


def test_the_families_share_the_network():
    ddpm = _ddpm("continuous")
    cfg = dataclasses.replace(ddpm.cfg, diffusion=dataclasses.replace(ddpm.cfg.diffusion, timestep_type="flow"))
    flow = DDPM(build_diffusion(cfg, ddpm.model), cfg)
    assert flow.model is ddpm.model and flow.device.type == "cuda"
    with pytest.raises(ValueError, match="dpmpp_2m"):
        flow.sample(1, 1, mode="dpmpp_2m")


@pytest.mark.parametrize("family,mode,forwards_per_step", SAMPLERS + [("continuous", "repaint", 2),
                                                                     ("flow", "repaint", 2)])
def test_the_replayed_chain_equals_the_eager_chain(family, mode, forwards_per_step):
    """Every sampler mode, and RePaint, gives the same bits with its forwards
    replayed as with them eager; the first forward captures (its warm-up is
    its answer), the rest replay. The wrappers are called by the warm-up and
    the capture alone; the card runs every forward's kernels."""
    ddpm = _ddpm(family)
    steps = 4
    if mode == "repaint":
        known = torch.rand((2, 2, 16, 64), device="cuda") * 2 - 1
        mask = (torch.arange(16, device="cuda") % 4 == 0).float().expand(2, 2, 64, 16).transpose(2, 3)

        def run():
            return ddpm.repaint(known, mask, 3, 2, 2, seeds=[0, 1])
        forwards = 5 * 2
    else:
        def run():
            return ddpm.sample(2, steps, seeds=[0, 1], mode=mode, return_all=True)
        forwards = steps * forwards_per_step
    eager, eager_counters = _eager(lambda: _counted(run))
    assert eager_counters["network.forwards"] == forwards and "network.graph_replays" not in eager_counters
    ((graphed, counters), launched), ran = _ran(lambda: _launched(lambda: _counted(run)))
    assert counters["network.forwards"] == forwards
    assert (counters["network.graph_captures"], counters["network.graph_replays"]) == (1, forwards - 1)
    assert launched == {k: v * 2 for k, v in PER_FORWARD.items()}
    assert ran == {k: v * forwards for k, v in PER_FORWARD.items()}
    assert torch.equal(graphed, eager)


def test_a_forward_hook_sees_every_replayed_forward():
    ddpm = _ddpm("continuous")
    model, seen = ddpm.model, []
    handle = model.register_forward_hook(lambda m, args, out: seen.append((args[0].clone(), args[1].clone(), out)))
    try:
        _, counters = _counted(lambda: ddpm.sample(2, 4, seeds=[0, 1], mode="ddim"))
    finally:
        handle.remove()
    assert counters["network.graph_replays"] == 3 and len(seen) == 4
    with torch.inference_mode():
        for x, t, out in seen:
            assert torch.equal(_eager(lambda: model(x, t)), out)


def test_an_output_kept_across_forwards_is_not_overwritten():
    """DPM-Solver++(2M) keeps the previous step's x_0 across the next
    forward: each call's output is its own tensor, never the graph's."""
    model = _ddpm("continuous").model
    x, t = _inputs()
    with torch.inference_mode():
        outs = [model(x * s, t) for s in (1.0, 0.5, 0.25, 0.125)]  # a capture, then replays
        kept = [o.clone() for o in outs]
        model(x * 2.0, t)
        torch.cuda.synchronize()
    (graph,) = model._graphs._graphs.values()
    assert all(o.data_ptr() != graph.output.data_ptr() for o in outs)
    assert all(torch.equal(o, k) for o, k in zip(outs, kept))
    assert not torch.equal(outs[1], outs[2])


@pytest.mark.parametrize("change", ["load_state_dict", "set_quant_conv", "fused_resample"])
def test_a_change_after_capture_recaptures(change, monkeypatch):
    model = _ddpm("continuous").model
    x, t = _inputs()
    with torch.inference_mode():
        model(x, t)
        model(x, t)
    if change == "load_state_dict":  # in place: the same storage, new values
        model.load_state_dict({k: v * 0.9 if v.is_floating_point() else v for k, v in model.state_dict().items()})
    elif change == "set_quant_conv":
        layers.set_quant_conv(model, "w8a8")
    else:
        monkeypatch.setattr(layers, "FUSED_RESAMPLE", "both")
    with torch.inference_mode():
        outs, counters = _counted(lambda: [model(x, t) for _ in range(3)])
        eager = _eager(lambda: model(x, t))
    assert (counters["network.graph_captures"], counters["network.graph_replays"]) == (1, 2)
    assert all(torch.equal(o, eager) for o in outs)


def test_swapping_in_the_plain_kernels_recaptures(monkeypatch):
    """The kernel-against-plain checks swap the plain GroupNorm and ring conv
    into ``layers``: the forward then captures anew, equal to the eager
    plain forward and not to the kernels' graph."""
    model = _ddpm("continuous").model
    x, t = _inputs()
    with torch.inference_mode():
        kernels = [model(x, t) for _ in range(2)]  # a capture, then a replay
        monkeypatch.setattr(layers, "fused_group_norm_silu", gn_silu.fused_group_norm_silu_plain)
        monkeypatch.setattr(layers, "fused_act_ringconv", act_ringconv.act_ringconv_plain)
        (outs, counters), ran = _ran(lambda: _counted(lambda: [model(x, t) for _ in range(3)]))
        plain = _eager(lambda: model(x, t))
    assert (counters["network.graph_captures"], counters["network.graph_replays"]) == (1, 2)
    assert ran == dict.fromkeys(PER_FORWARD, 0)
    assert all(torch.equal(o, plain) for o in outs)
    assert torch.equal(kernels[0], kernels[1]) and not torch.equal(plain, kernels[0])


def test_no_grad_after_inference_mode_at_one_shape():
    """Each mode has its graph: the composed down weight is cached per mode,
    and the graph of the other mode keeps its own alive."""
    model = _ddpm("continuous").model
    x, t = _inputs()
    outs = []
    for mode in (torch.inference_mode, torch.no_grad, torch.inference_mode, torch.no_grad):
        with mode():
            outs += [model(x, t), model(x, t)]
    with torch.inference_mode():
        eager = _eager(lambda: model(x, t))
    assert len(model._graphs._graphs) == 2
    assert all(torch.equal(o, eager) for o in outs)


def test_a_forward_over_the_pixel_limit_runs_eagerly():
    model = _ddpm("continuous").model
    x, t = _inputs(forward_graph.MAX_GRAPH_PIXELS // (16 * 64) + 1)
    with torch.inference_mode():
        out, counters = _counted(lambda: model(x, t))
    assert counters["network.forwards"] == 1 and "network.graph_captures" not in counters
    assert model._graphs._graphs == {} and bool(torch.isfinite(out).all())


def test_a_caller_may_graph_the_whole_forward():
    """``chip_smoke.py::graph_ms`` captures whole forwards: inside its
    capture the forward runs eagerly into the caller's graph."""
    import chip_smoke

    model = _ddpm("continuous").model
    x, t = _inputs()
    with torch.inference_mode():
        ms, counters = _counted(lambda: chip_smoke.graph_ms(torch, lambda: model(x, t), iters=2))
    # graph_ms's three warm-up calls: a capture and two replays; its own capture runs eagerly
    assert ms > 0 and counters["network.forwards"] == 5
    assert (counters["network.graph_captures"], counters["network.graph_replays"]) == (1, 2)
