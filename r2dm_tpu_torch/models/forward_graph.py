"""A network's inference forward replayed as a CUDA graph.

A forward of config H at a small batch is about 720 kernel launches, and
the host's Python, checks and ctypes calls around them take longer than the
card takes to run them. A CUDA graph of the forward launches the same
hand-written, cuDNN and ATen kernels in one call, so the host stops setting
the pace. No kernel changes.

``ForwardGraphs`` holds one graph a key: everything the forward reads
besides its tensors' values (``key``), the functions it calls through
module globals included, so that a function swapped in (a plain version in
place of a kernel) is captured anew. The first forward with a new key runs
on a side stream as the warm-up the capture needs, and its output is that
call's answer; the forward is then captured into static inputs. Every later
call with the key copies its images and timesteps into them, replays on the
current stream, and returns a fresh copy of the static output, so an output
kept across forwards is never overwritten. A module's graphs share one
memory pool: replays run one at a time on the caller's stream and each
output is copied out before the next, so a graph may reuse what another's
capture freed. A new state of the parameters (an in-place load, an
optimizer step, a move to another device) drops the graphs of the old one.

The kernel wrappers' launch counters (``ops.KERNEL_WRAPPERS``) count their
calls: the warm-up's launches, and the capture's, which record the kernels
into the graph. A replay runs those kernels with no wrapper call, so the
kernels a replayed forward ran are read from the card's own record of them
(a ``torch.profiler`` trace; ``chip_smoke.py::device_launches``). With
tracing on (``utils/trace.py``) the captures and replays count in
``network.graph_captures`` and ``network.graph_replays``.

``eager_reason`` says which forwards run eagerly, as before.
"""

from __future__ import annotations

import dataclasses
import inspect
import sys
from typing import Optional

import torch

from ..ops import fused_resample
from ..utils import trace
from . import layers

# Above 2**20 pixels (B*H*W, b16 at 64x1024) a forward runs eagerly. The
# host's enqueue of a config-H forward is about fixed (720 launches: 17-26 ms
# at b8-b64 on an H100's host, up to 40 ms on slower hosts), while the
# replayed forward's device time grows with the batch (13.6, 26.2, 48.9 and
# 95.1 ms at b8, b16, b32 and b64), and so does the graph's pool (1.3, 2.5,
# 5.0 and 10.0 GB). Back to back, eager forwards took 17.5, 27.7, 51.1 and
# 97.3 ms: the host sets the pace up to about b16, where its enqueue (25.9
# ms) meets the device's time; beyond, the device does, and the graph buys
# 4 % for 5 GB at b32 (PERF.md §6, the pixel limit).
MAX_GRAPH_PIXELS = 1 << 20


def eager_reason(*, training: bool, grad: bool, generator: bool, width: bool, cuda: bool, capturing: bool,
                 pixels: int) -> Optional[str]:
    """Why a forward runs eagerly, or None when it may replay a graph:
    the module is in training mode (dropout draws), autograd is on, a
    ``generator`` is given, a width axis is set (its forward runs
    collectives), the images are not on a card, the current stream is
    already capturing (a caller graphing the forward itself), or the
    forward has more than ``MAX_GRAPH_PIXELS`` pixels."""
    reasons = (("training mode", training), ("autograd", grad), ("generator", generator), ("width axis", width),
               ("not on CUDA", not cuda), ("stream capturing", capturing), ("pixels", pixels > MAX_GRAPH_PIXELS))
    return next((why for why, hit in reasons if hit), None)


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    images: torch.Tensor  # the static inputs and output
    timesteps: torch.Tensor
    output: torch.Tensor
    keep: list  # the convs' cached weights the graph reads


class ForwardGraphs:
    """The CUDA graphs of one module's forward, one a ``key``. The module
    gives ``_forward(images, timesteps)``, the eager forward. A copy or a
    pickle of the module starts with none."""

    def __init__(self):
        self._graphs: dict = {}
        self._pool = None  # the memory pool the graphs share
        self._tensors = None  # (dict, name) of every parameter and buffer
        self._convs = None
        self._calls = None  # (module dict, name) of every function the forward may call through a global

    def __reduce__(self):
        return ForwardGraphs, ()

    def eager_reason(self, module: torch.nn.Module, images: torch.Tensor, generator) -> Optional[str]:
        """``eager_reason`` of this forward of ``module``."""
        cuda = images.is_cuda
        return eager_reason(training=module.training, grad=torch.is_grad_enabled(), generator=generator is not None,
                            width=module.width_shard is not None, cuda=cuda,
                            capturing=cuda and torch.cuda.is_current_stream_capturing(),
                            pixels=images.shape[0] * images.shape[1] * images.shape[2])

    def key(self, module: torch.nn.Module, images: torch.Tensor, timesteps: torch.Tensor) -> tuple:
        """Everything the forward reads besides its tensors' values: the
        images' shape, dtype and device, the timesteps' dtype, inference
        mode, ``layers.FUSED_RESAMPLE``, each conv's int8 lane, the TF32
        settings, the functions bound to the names of ``layers``,
        ``fused_resample`` and the network's own module (a test swaps a
        kernel's plain version in there), and last the state: every
        parameter's and buffer's storage and version (the composed down
        weight and the s8 pack are caches keyed on the weight's version,
        which a graph would read stale after an in-place load)."""
        if self._tensors is None:
            mods = list(module.modules())
            self._tensors = [(m._parameters, n) for m in mods for n in m._parameters] + \
                            [(m._buffers, n) for m in mods for n in m._buffers]
            self._convs = [m for m in mods if isinstance(m, layers.RingConv)]
            self._calls = [(vars(m), n) for m in (layers, fused_resample, sys.modules[type(module).__module__])
                           for n, f in vars(m).items() if inspect.isfunction(f)]
        state = tuple(None if (t := d[n]) is None else (t.data_ptr(), t._version) for d, n in self._tensors)
        return (tuple(images.shape), images.dtype, images.device, timesteps.dtype,
                torch.is_inference_mode_enabled(), layers.FUSED_RESAMPLE, tuple(c.quant for c in self._convs),
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                tuple(d[n] for d, n in self._calls), state)

    def __call__(self, module: torch.nn.Module, images: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """The forward of ``module`` by its graph for this key, captured
        first when there is none."""
        key = self.key(module, images, timesteps)
        entry = self._graphs.get(key)
        if entry is None:
            return self._capture(module, key, images, timesteps)
        with torch.cuda.device(images.device):
            entry.images.copy_(images)
            entry.timesteps.copy_(timesteps)
            entry.graph.replay()
            out = entry.output.clone()
        trace.count("network.graph_replays")
        return out

    def _capture(self, module, key, images, timesteps) -> torch.Tensor:
        state = key[-1]
        self._graphs = {k: g for k, g in self._graphs.items() if k[-1] == state}
        dev = images.device
        if not self._graphs:  # a new state or device: the old graphs' memory goes with them
            self._pool = torch.cuda.graph_pool_handle()
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            current = torch.cuda.current_stream(dev)
            side.wait_stream(current)
            with torch.cuda.stream(side):  # the warm-up, off the current stream as capture requires
                out = module._forward(images, timesteps)
            current.wait_stream(side)
            out.record_stream(current)  # made on the side stream, used on the caller's
            static_images = torch.empty_like(images, memory_format=torch.contiguous_format)
            static_timesteps = torch.empty(images.shape[:1], dtype=timesteps.dtype, device=dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=side, capture_error_mode="thread_local"):
                static_output = module._forward(static_images, static_timesteps)
        keep = [(c._composed, c._packed) for c in self._convs]
        self._graphs[key] = _Graph(graph, static_images, static_timesteps, static_output, keep)
        trace.count("network.graph_captures")
        return out
