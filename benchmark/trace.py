"""Spans on the host's clock and the reading of a ``torch.profiler`` window.

``Spans`` keeps, per name, the seconds of each span the benchmark records
around its calls into the program (always on: two clock reads a span).

``profiled(segment, wrap, host)`` runs ``segment()`` under the profiler
(the device's activity; with ``host`` the host's too, inside a
``bench.window`` range), with the program's callables listed in ``wrap``
(``(owner, attribute, label, work)``) each wrapped in a
``record_function(label)`` range that also adds up ``work(args, result)``,
the least seconds of that call's work (``roofline/kernels.py``). It returns
``Profile``:

- ``window_s``: the host-clock length of the window (synchronised at both ends);
- ``busy_s``: the seconds in which some device operation (kernel, copy,
  memset) ran, the union of their intervals inside the window;
- ``kernels``: the kernels launched (copies and memsets are not kernels);
- ``device_ops``: the ten device operations with the most time, summed by name;
- ``idle_gaps``: the ten longest stretches with no device operation, each
  named (with ``host``) by the benchmark's range and the host operation
  running at its start;
- ``ranges``: per wrapped label, its calls, the device seconds of the kernels
  launched inside them, and the least seconds of their work.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

PREFIX = "bench."


class Spans:
    def __init__(self):
        self.seconds: dict[str, list[float]] = defaultdict(list)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name].append(time.perf_counter() - t0)


@dataclass
class Profile:
    window_s: float
    busy_s: float
    kernels: int
    device_ops: list
    idle_gaps: list
    ranges: dict = field(default_factory=dict)


@contextmanager
def _wrapped(wrap, work_total):
    saved = []
    for owner, attr, label, work in wrap:
        original = getattr(owner, attr)

        def wrapper(*args, _original=original, _label=label, _work=work, **kwargs):
            with torch.profiler.record_function(PREFIX + _label):
                out = _original(*args, **kwargs)
            work_total[_label] += _work(args, out)
            return out

        setattr(owner, attr, wrapper)
        saved.append((owner, attr, original))
    try:
        yield
    finally:
        for owner, attr, original in reversed(saved):
            setattr(owner, attr, original)


def profiled(segment, wrap=(), device=None, host: bool = False) -> Profile:
    """``segment()`` under the profiler: the device's activity alone, or with
    ``host`` the host's operations and the benchmark's ranges too (which
    slows the host's enqueue several fold: a host-bound cell's idle share is
    read without them)."""
    from torch.profiler import ProfilerActivity, profile

    work_total: dict[str, float] = defaultdict(float)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with _wrapped(wrap, work_total), profile(activities=activities) as prof:
        with torch.profiler.record_function(PREFIX + "window"):
            t0 = time.perf_counter()
            segment()
            torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
    return read(prof, window_s, work_total, host)


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(PREFIX)


def read(prof, window_s: float, work_total: dict, host: bool = True) -> Profile:
    events = list(prof.events())
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events if _is_device(e))
    if host:  # the window's range on the host clears what ran before it
        window = next(e for e in cpu if e.name == PREFIX + "window")
        w0, w1 = window.time_range.start, window.time_range.end
        dev = [(max(s, w0), min(t, w1), n) for s, t, n in dev]
        dev = [d for d in dev if d[1] > d[0]]
    elif dev:  # synchronised before and after: every device operation lies in the window
        w0, w1 = dev[0][0], max(t for _, t, _ in dev)
    else:
        w0 = w1 = 0.0
    busy, gaps, at = 0.0, [], w0
    for s, t, _ in dev:
        if s > at:
            gaps.append((s - at, at))
        if t > at:
            busy += t - max(s, at)
            at = t
    if w1 > at:
        gaps.append((w1 - at, at))
    by_name = defaultdict(float)
    for s, t, name in dev:
        by_name[name] += t - s
    kernels = sum(1 for _, _, n in dev if not n.startswith(("Memcpy", "Memset")))
    ranges = {}
    for avg in prof.key_averages() if host else ():
        if avg.key.startswith(PREFIX) and avg.key != PREFIX + "window":
            label = avg.key[len(PREFIX):]
            ranges[label] = {"calls": avg.count, "device_s": avg.device_time_total / 1e6,
                             "least_s": work_total.get(label, 0.0)}
    return Profile(
        window_s=window_s, busy_s=busy / 1e6, kernels=kernels,
        device_ops=[[n[:120], s / 1e6] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[_doing(cpu, g0) if host else "host not traced", g / 1e6] for g, g0 in sorted(gaps, reverse=True)[:10]],
        ranges=ranges)


def _doing(host: list, t: float) -> str:
    """The benchmark's innermost range and the deepest host operation that
    were open at time ``t``."""
    ours, op = "", ""
    best_ours = best_op = None
    for e in host:
        s, u = e.time_range.start, e.time_range.end
        if s <= t < u:
            if e.name.startswith(PREFIX) and e.name != PREFIX + "window":
                if best_ours is None or s >= best_ours:
                    best_ours, ours = s, e.name[len(PREFIX):]
            elif not e.name.startswith(PREFIX):
                if best_op is None or s >= best_op:
                    best_op, op = s, e.name
    return f"{ours or 'outside'}: {op or 'python'}"[:120]


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of ``values``."""
    v = sorted(values)
    k = max(1, -(-len(v) * q // 100))
    return v[int(k) - 1]


def roofline_share(observed: dict, label: str):
    """A wrapped work's least seconds over its kernels' device seconds, in
    percent; None when the traced run saw no such call or no kernel in it."""
    p = observed.get("profile_host")
    r = p.ranges.get(label) if p is not None else None
    if not r or r["device_s"] <= 0 or r["least_s"] <= 0:
        return None
    return 100.0 * r["least_s"] / r["device_s"]


def mfu(observed: dict):
    """The network's operations over the timed window: the frozen operations
    of a unit of work (a step or a request) times the units the window
    completed, over the window's seconds times the card's bf16 peak, in
    percent."""
    from .roofline import PEAK_BF16_FLOPS

    w = observed.get("window")
    if not w or not w["units"]:
        return None
    return 100.0 * w["flops_per_unit"] * w["units"] / (w["seconds"] * PEAK_BF16_FLOPS)


def idle_share(observed: dict):
    """The share of the timed window in which no operation ran on the device,
    in percent: one minus the device's busy seconds a unit of work in the
    profiled window (the union of its operations' intervals, a device-only
    trace) times the units the timed window completed, over its seconds. The
    device's time a unit does not depend on how fast the host enqueues it, so
    the profiler's host overhead stays out of the share."""
    p, w = observed.get("profile"), observed.get("window")
    if p is None or not w or not w["units"] or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / w["profile_units"] * w["units"] / w["seconds"])
