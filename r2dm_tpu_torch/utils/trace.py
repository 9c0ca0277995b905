"""Spans and counters inside the port, off by default.

Turn tracing on around the work to look at, and read what it recorded::

    from r2dm_tpu_torch.utils import trace

    trace.enable()
    ddpm.sample(8, 16, mode="ddim", seeds=seeds)
    snap = trace.snapshot()   # {"spans": [...], "counters": {...}}
    trace.disable()

While tracing is on and a ``torch.profiler`` session is active, each span
is also a ``record_function`` range: ``python -m r2dm_tpu_torch.train
--training.profile_dir DIR`` turns tracing on for its profiled steps 10-15,
and the spans show in ``DIR/trace.json`` beside the kernels.

The spans, by layer (a name is its layer, a dot, and the work):

- ``entry.setup_model``: ``inference.setup_model``, with children
  ``entry.build`` (the network built on the host), ``entry.load_weights``
  (the state dict converted and loaded) and ``entry.to_device``;
- ``entry.sample``: ``DDPM.sample`` and ``DDPM.repaint``, a request's root:
  every span under it carries its request id;
- ``entry.points``: ``sample_and_save.postprocess``, scans to depth, points
  and reflectance;
- ``sampler.step``: one denoising step of any sampler loop (DDPM, DDIM,
  DPM-Solver++, the flow ODE, one outer step of RePaint);
- ``network.forward``: one forward of the EfficientUNet or the RefineNet;
- ``train.step``: ``training.step``'s ``train_step``, with children
  ``train.loss`` (the forward and the loss), ``train.backward`` (the
  gradients, with their all-reduce under a width axis) and ``train.update``
  (clip, AdamW, schedule and EMA; under accumulation the running mean too);
- ``data.make_batch``: one batch built by ``data.DataLoader``'s prefetch
  thread;
- ``parallel.collective``: one collective of the width axis
  (``parallel/width.py``).

The counters: ``data.gets`` (batches the loader handed out) and
``data.gets_empty`` (of those, the ones asked for while its prefetch queue
was empty); ``network.forwards`` (forwards of the EfficientUNet),
``network.graph_captures`` and ``network.graph_replays`` (of those, the ones
that captured or replayed a CUDA graph, ``models/forward_graph.py``),
recorded while tracing is on; and, read when ``snapshot()`` is
taken, the always-on launch counts of ``ops.KERNEL_WRAPPERS``
(``ops.<wrapper>.launches``; the ring conv's also by tile variant,
``ops.<wrapper>.launches.<variant>``), the calls of the composed resample convs
(``ops.<function>.calls``), both since ``ops.reset_launch_counts()`` or the
process's start, and with ``snapshot(world)`` that world's
``parallel.collective_calls``. The launch counts and the calls count the
wrappers' calls: a replayed CUDA graph runs its kernels with none.

A span record is a dict: ``name``; ``t0`` and ``t1``, the host clock
(``time.perf_counter``) at its start and end; ``parent``, the index of the
span open on the same thread when it started (None at a thread's top);
``thread``, the thread's name; ``request``, the id of the ``entry.sample``
it runs under (None outside one); and ``d0``, ``d1``. A span opened with
``device=`` a CUDA tensor records a CUDA event at its start and end on that
tensor's device's current stream, and ``d0``/``d1`` are the times the device
reached them, on the host's clock (None for other spans): ``enable()``
records an anchor event beside a host clock read, and ``snapshot()`` puts
each event at the anchor's host time plus its elapsed time from the anchor
(about 10 us of error). So ``d0 - t0`` is how long the span's work waited
in the stream behind earlier work: near 0, the device was waiting for the
host. ``gaps()`` names the host span the device waited on between two
device intervals.

When tracing is off ``span()`` returns one shared no-op context manager: a
flag test, no allocation. Spans sit at layer boundaries, never on a
per-kernel-launch path. The recorder is one per process, since the spans
sit in library code that holds no handle to pass one through.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Iterable, Optional, Union

import torch

_on = False
_records: list = []
_counters: dict = {}
_lock = threading.Lock()
_local = threading.local()
_requests = itertools.count(1)
_anchors: dict = {}  # device index -> (anchor event, its host time)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


class _Record:
    __slots__ = ("name", "t0", "t1", "parent", "thread", "request", "device", "events", "anchor")


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _anchor(device: torch.device):
    """The device's anchor: an event recorded on an idle device, and the
    host clock then (the midpoint of the record and its completion)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    anchor = _anchors.get(index)
    if anchor is None:
        torch.cuda.synchronize(index)
        event = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        event.record(torch.cuda.current_stream(index))
        event.synchronize()
        anchor = _anchors[index] = (event, 0.5 * (h0 + time.perf_counter()))
    return anchor


class _Span:
    __slots__ = ("rec", "range")

    def __init__(self, name: str, device: Optional[torch.Tensor], request: bool):
        stack = _stack()
        rec = self.rec = _Record()
        rec.name, rec.t1, rec.events, rec.anchor = name, None, None, None
        rec.parent = stack[-1] if stack else None
        rec.thread = threading.current_thread().name
        rec.request = next(_requests) if request else (rec.parent.request if rec.parent is not None else None)
        rec.device = device.device if device is not None and device.is_cuda else None
        self.range = None

    def __enter__(self):
        rec = self.rec
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(rec.name)
            self.range.__enter__()
        if rec.device is not None:
            rec.anchor = _anchor(rec.device)
            rec.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        _stack().append(rec)
        _records.append(rec)
        rec.t0 = time.perf_counter()
        if rec.events is not None:
            rec.events[0].record(torch.cuda.current_stream(rec.device))
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(rec.device))
        rec.t1 = time.perf_counter()
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, device: Optional[torch.Tensor] = None, request: bool = False):
    """A context manager recording the span ``name`` while tracing is on;
    the shared no-op otherwise. ``device``: a tensor whose device's current
    stream the span's CUDA events go on (none for a CPU tensor).
    ``request``: the span opens a request of its own."""
    if not _on:
        return _NOOP
    return _Span(name, device, request)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)


def on() -> bool:
    return _on


def enable() -> None:
    """Start recording; on a card, synchronise and take a fresh anchor."""
    global _on
    _anchors.clear()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        _anchor(torch.device("cuda", torch.cuda.current_device()))
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``reset()``."""
    global _on
    _on = False


def reset() -> None:
    """Forget every span and program counter recorded so far."""
    with _lock:
        _records.clear()
        _counters.clear()


def snapshot(world=None) -> dict:
    """What was recorded, as plain data: ``{"spans": [record, ...],
    "counters": {name: value}}``, the spans that have ended, in the order
    they started (the module docstring gives the fields). Synchronises the
    devices of the device spans once."""
    closed = [r for r in list(_records) if r.t1 is not None]
    index = {id(r): i for i, r in enumerate(closed)}
    for dev in {r.device for r in closed if r.events is not None}:
        torch.cuda.synchronize(dev)
    spans = []
    for r in closed:
        d0 = d1 = None
        if r.events is not None:
            event, host = r.anchor
            d0, d1 = (host + event.elapsed_time(e) / 1e3 for e in r.events)
        spans.append({"name": r.name, "t0": r.t0, "t1": r.t1,
                      "parent": None if r.parent is None else index.get(id(r.parent)),
                      "thread": r.thread, "request": r.request, "d0": d0, "d1": d1})
    with _lock:
        counters = dict(_counters)
    counters.update(_op_counters())
    if world is not None:
        counters["parallel.collective_calls"] = world.collective_calls
    return {"spans": spans, "counters": counters}


def _op_counters() -> dict:
    from .. import ops
    from ..ops import fused_resample

    out = {f"ops.{fn.__name__}.launches": fn.launches for fn in ops.KERNEL_WRAPPERS}
    for fn in ops.KERNEL_WRAPPERS:
        for tile, n in getattr(fn, "tile_launches", {}).items():
            out[f"ops.{fn.__name__}.launches.{tile}"] = n
    for fn in (fused_resample.conv_then_downsample, fused_resample.upsample_then_conv):
        out[f"ops.{fn.__name__}.calls"] = fn.calls
    return out


def total(snap: dict, name: str) -> float:
    """The host seconds of every span ``name`` in ``snap``, summed."""
    return sum(s["t1"] - s["t0"] for s in snap["spans"] if s["name"] == name)


def self_time(snap: dict, i: int) -> float:
    """Span ``i``'s host seconds less the part its children cover."""
    s = snap["spans"][i]
    return (s["t1"] - s["t0"]) - sum(c["t1"] - c["t0"] for c in snap["spans"] if c["parent"] == i)


def gaps(snap: dict, names: Union[str, Iterable[str]]) -> list[dict]:
    """The stretches between consecutive device intervals of the spans
    ``names`` (one name or several), in time order: each a dict of ``start``
    (the host clock when the device reached the end of the earlier work),
    ``seconds`` and ``label``, the innermost span open then on the thread of
    the interval that ended the stretch (``"outside"`` when none was). A
    stretch is the device's idle time when the intervals of ``names`` cover
    all the work it was given (``entry.sample`` and ``entry.points`` for a
    request); work outside them counts as a stretch too."""
    names = {names} if isinstance(names, str) else set(names)
    spans = snap["spans"]
    intervals = sorted((s["d0"], s["d1"], s["thread"]) for s in spans if s["name"] in names and s["d0"] is not None)
    out, busy_to = [], None
    for d0, d1, thread in intervals:
        if busy_to is not None and d0 > busy_to:
            inner = [s for s in spans if s["thread"] == thread and s["t0"] <= busy_to < s["t1"]]
            label = max(inner, key=lambda s: s["t0"])["name"] if inner else "outside"
            out.append({"start": busy_to, "seconds": d0 - busy_to, "label": label})
        busy_to = d1 if busy_to is None else max(busy_to, d1)
    return out
