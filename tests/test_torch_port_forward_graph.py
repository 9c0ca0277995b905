"""The EfficientUNet's CUDA-graph forward (``models/forward_graph.py``) on
the CPU: which forwards run eagerly, what the graphs' key reads, and that a
forward on the CPU is the eager forward with no graph and no counter of one.
The replays themselves run on the card (``test_torch_port_serving_cuda.py``).

This file imports no JAX."""

import copy
import pickle

import pytest
import torch

from r2dm_tpu_torch.models import forward_graph, layers
from r2dm_tpu_torch.ops import act_ringconv, gn_silu, quant
from r2dm_tpu_torch.models.efficient_unet import EfficientUNet
from r2dm_tpu_torch.utils import trace

torch.set_num_threads(1)

# every fact of a forward that may replay a graph
GRAPHABLE = dict(training=False, grad=False, generator=False, width=False, cuda=True, capturing=False,
                 pixels=8 * 64 * 1024)


def _tiny() -> EfficientUNet:
    torch.manual_seed(0)
    model = EfficientUNet(resolution=(16, 64), base_channels=16, gn_num_groups=4, attn_num_heads=4,
                          num_residual_blocks=(1, 1, 1, 1)).eval()
    with torch.no_grad():
        model.out_conv.weight.normal_(0.0, 0.05)
    return model


def _inputs(batch: int = 2, dtype=torch.float32):
    g = torch.Generator().manual_seed(1)
    return torch.randn((batch, 16, 64, 2), generator=g).to(dtype), torch.rand((batch,), generator=g)


def test_a_small_inference_forward_on_a_card_replays():
    assert forward_graph.eager_reason(**GRAPHABLE) is None
    assert forward_graph.eager_reason(**dict(GRAPHABLE, pixels=forward_graph.MAX_GRAPH_PIXELS)) is None


@pytest.mark.parametrize("fact,value,reason", [
    ("training", True, "training mode"),
    ("grad", True, "autograd"),
    ("generator", True, "generator"),
    ("width", True, "width axis"),
    ("cuda", False, "not on CUDA"),
    ("capturing", True, "stream capturing"),
    ("pixels", forward_graph.MAX_GRAPH_PIXELS + 1, "pixels"),
])
def test_each_bypass_runs_the_forward_eagerly(fact, value, reason):
    assert forward_graph.eager_reason(**dict(GRAPHABLE, **{fact: value})) == reason


def test_the_pixel_limit_takes_b16_and_leaves_b32_eager():
    """b8 and b16 at 64x1024 replay; b32 and the b256 chain run eagerly."""
    at = {b: forward_graph.eager_reason(**dict(GRAPHABLE, pixels=b * 64 * 1024)) for b in (8, 16, 32, 256)}
    assert at == {8: None, 16: None, 32: "pixels", 256: "pixels"}


def test_the_module_reads_its_facts():
    model = _tiny()
    graphs = model._graphs
    x, _ = _inputs()
    with torch.inference_mode():
        assert graphs.eager_reason(model, x, None) == "not on CUDA"
    with torch.no_grad():
        assert graphs.eager_reason(model, x, torch.Generator()) == "generator"
        model.train()
        assert graphs.eager_reason(model, x, None) == "training mode"
    model.eval()
    assert graphs.eager_reason(model, x, None) == "autograd"


def test_a_cpu_forward_is_the_eager_forward_with_no_graph():
    model = _tiny()
    x, t = _inputs()
    with torch.inference_mode():
        eager = model._forward(x, t)
        trace.reset()
        trace.enable()
        try:
            out = model(x, t)
            counters = trace.snapshot()["counters"]
        finally:
            trace.disable()
            trace.reset()
    assert torch.equal(out, eager) and out.dtype == torch.float32
    assert counters["network.forwards"] == 1
    assert "network.graph_replays" not in counters and "network.graph_captures" not in counters
    assert model._graphs._graphs == {}


@pytest.mark.parametrize("change", ["fused_resample", "quant", "version", "dtype", "batch", "inference_mode",
                                    "fused_group_norm_silu", "fused_act_ringconv", "ring_conv_w8a8"])
def test_the_graph_key_changes_with_what_the_forward_reads(change, monkeypatch):
    """Each fact the forward reads besides its tensors' values, down to the
    function a global of ``layers`` names (a kernel's plain version swapped
    in, as the kernel-against-plain checks do)."""
    model = _tiny()
    x, t = _inputs()

    def key(x=x):
        with torch.inference_mode():
            return model._graphs.key(model, x, t)

    before = key()
    assert key() == before
    if change == "fused_resample":
        monkeypatch.setattr(layers, "FUSED_RESAMPLE", False)
        after = key()
    elif change == "quant":
        layers.set_quant_conv(model, "w8a8")
        after = key()
    elif change == "version":
        with torch.no_grad():
            model.d_block2.residual_blocks[0].conv1.weight.mul_(1.0)  # same values, a new version
        after = key()
    elif change == "dtype":
        after = key(x.to(torch.bfloat16))
    elif change == "batch":
        after = key(_inputs(batch=3)[0])
    elif change != "inference_mode":
        plain = {"fused_group_norm_silu": gn_silu.fused_group_norm_silu_plain,
                 "fused_act_ringconv": act_ringconv.act_ringconv_plain,
                 "ring_conv_w8a8": lambda x, kernel, bias, out_dtype=None, packed=None, width=None:
                 quant.ring_conv_w8a8_plain(x, kernel, bias, out_dtype)}
        monkeypatch.setattr(layers, change, plain[change])
        after = key()
    else:
        with torch.no_grad():
            after = model._graphs.key(model, x, t)
    assert after != before


def test_an_in_place_load_changes_only_the_state():
    model = _tiny()
    x, t = _inputs()
    before = model._graphs.key(model, x, t)
    model.load_state_dict(_tiny().state_dict())
    after = model._graphs.key(model, x, t)
    assert after[:-1] == before[:-1] and after[-1] != before[-1]


@pytest.mark.parametrize("how", ["deepcopy", "pickle"])
def test_a_copy_of_the_model_starts_with_no_graph(how):
    model = _tiny()
    x, t = _inputs()
    model._graphs.key(model, x, t)
    model._graphs._graphs[("stale",)] = object()  # as a captured graph would sit there
    clone = copy.deepcopy(model) if how == "deepcopy" else pickle.loads(pickle.dumps(model))
    assert clone._graphs is not model._graphs and clone._graphs._graphs == {}
    assert clone._graphs._tensors is None
    with torch.inference_mode():
        assert torch.equal(clone(x, t), model._forward(x, t))
