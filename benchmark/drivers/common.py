"""What every driver shares: the run's context, seeds derived from the run's
seed, the program's configuration built from a configuration file, the
sensor's ray angles, and the comparison helpers of the correctness check."""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import manifest
from ..reference.unet import hdl64e_angles
from ..trace import Spans


@dataclass
class Context:
    cell: str
    seed: int
    seconds: float
    trace: bool
    cfg: dict  # the configuration file
    traffic: dict  # the workload file
    device: torch.device
    t_start: float  # the host clock when the process started
    control: Optional[str] = None  # the correctness check's control, never set by a timed run
    spans: Spans = field(default_factory=Spans)


@dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: dict  # end-to-end values, by name
    observed: dict  # what the per-layer readers read
    checks: dict  # name -> (value, limit)
    peak: int = 0  # the device's peak of allocated bytes, read as the window closed


def derive(*parts: int) -> int:
    """A 63-bit seed from the run's seed and indices."""
    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def program_config(cfg: dict):
    """The port's ``Config`` of a configuration file: the data, diffusion,
    training and precision every configuration states, and the network's
    fields from its architecture module."""
    from r2dm_tpu_torch import config as config_lib

    c = config_lib.Config()
    c.data.dataset, c.data.resolution = "synthetic", tuple(cfg["resolution"])
    c.data.depth_format, c.data.min_depth, c.data.max_depth = cfg["depth_format"], cfg["min_depth"], cfg["max_depth"]
    c.data.projection = cfg["projection"]
    manifest.architecture(cfg).program_model(cfg, c.model)
    d = c.diffusion
    d.timestep_type, d.noise_schedule = cfg["timestep_type"], cfg["noise_schedule"]
    d.prediction_type, d.loss_type = cfg["prediction_type"], cfg["loss_type"]
    t, tc = c.training, cfg["training"]
    t.batch_size_train, t.lr, t.lr_warmup_steps, t.num_steps = tc["batch_size"], tc["lr"], tc["lr_warmup_steps"], tc["num_steps"]
    t.adam_beta1, t.adam_beta2 = tc["adam_betas"]
    t.adam_epsilon, t.adam_weight_decay = tc["adam_eps"], tc["weight_decay"]
    t.ema_decay, t.ema_update_every = tc["ema_decay"], tc["ema_update_every"]
    t.mixed_precision = "bf16" if cfg["compute_dtype"] == "bfloat16" else "no"
    return c


def ray_angles(cfg: dict, device) -> torch.Tensor:
    """The sensor's ray angles on the configuration's grid, as the reference
    computes them: what the port's ``LiDARUtility`` projects with."""
    return hdl64e_angles(*cfg["resolution"], device=device)


def program_control(ctx: Context, model: torch.nn.Module) -> None:
    """For the control ``int8``, the program's own int8 lane on ``model``, by
    the architecture module's ``quantize``. Refused where the network has no
    such lane or the lane switches no module: the control would then be the
    program itself. Any other control is the check's to apply."""
    if ctx.control != "int8":
        return
    arch = manifest.architecture(ctx.cfg)
    if not hasattr(arch, "quantize") or arch.quantize(model) == 0:
        raise ValueError(f"the port's {ctx.cfg['architecture']!r} network has no int8 lane; "
                         f"its controls are {arch.CONTROLS}")


def reference_eps(net: torch.nn.Module, x: torch.Tensor, cond: torch.Tensor, rows: int,
                  quant: Optional[str] = None) -> torch.Tensor:
    """The reference network's output on ``x``, ``rows`` rows at a time; with
    ``quant`` (the control ``fp8``) computed in that precision."""
    net.set_quant(quant)
    try:
        return torch.cat([net(x[i:i + rows], cond[i:i + rows]) for i in range(0, len(x), rows)])
    finally:
        net.set_quant(None)


def compute_dtype(cfg: dict, device: torch.device) -> Optional[torch.dtype]:
    """The configuration's compute type on the card; float32 (None) on the
    CPU, where the harness's tests drive it."""
    return torch.bfloat16 if device.type == "cuda" and cfg["compute_dtype"] == "bfloat16" else None


def rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.double(), ref.double()
    return float(torch.linalg.vector_norm(a - ref) / torch.linalg.vector_norm(ref).clamp_min(1e-30))


def leaf_gap(ours: list, ref: list, keep: Optional[list] = None) -> tuple[float, int]:
    """The worst leaf of |‖ours‖ - ‖ref‖| / max(‖ref‖, the median leaf's
    ‖ref‖): (the gap, the leaf's index)."""
    n_ours = [float(torch.linalg.vector_norm(t.double())) for t in ours]
    n_ref = [float(torch.linalg.vector_norm(t.double())) for t in ref]
    med = float(np.median(n_ref))
    idx = range(len(n_ref)) if keep is None else keep
    return max((abs(n_ours[i] - n_ref[i]) / max(n_ref[i], med, 1e-30), i) for i in idx)


class Recorder:
    """A forward hook on the network, for the correctness check. While a slot
    is open it copies each forward's input x_t, condition and output into
    that slot's pinned host buffers, allocated before the window so that a
    recorded call pays only the copies (forwards past the buffers are
    counted, not kept); opened with ``rows`` it also keeps those rows of each
    forward's input and output on the card."""

    def __init__(self, model: torch.nn.Module, slots: int, forwards: int, shape: tuple, device: torch.device,
                 rows=None):
        self.pin = device.type == "cuda"

        def buf(s):
            return torch.empty(s, dtype=torch.float32, pin_memory=self.pin)

        self.bufs = [[(buf(shape), buf(shape[:1]), buf(shape)) for _ in range(forwards)] for _ in range(slots)]
        self.rows = None if rows is None else torch.as_tensor(rows, device=device)
        self.slot, self.at, self.keep_rows, self.on_card = None, 0, False, []
        self.handle = model.register_forward_hook(self._hook)

    def _hook(self, module, args, output):
        if self.keep_rows:
            self.on_card.append((args[0][self.rows].clone(), output[self.rows].clone()))
        if self.slot is None:
            return
        if self.at < len(self.bufs[self.slot]):
            for dst, src in zip(self.bufs[self.slot][self.at], (args[0], args[1], output)):
                dst.copy_(src, non_blocking=self.pin)
        self.at += 1

    def open(self, slot=None, rows: bool = False) -> None:
        self.slot, self.at, self.keep_rows, self.on_card = slot, 0, rows, []

    def close(self) -> tuple[list, list]:
        """The slot's host copies, one (input, condition, output) per forward
        seen (None for each when more came than it holds), and the rows kept
        on the card, one (input, output) per forward."""
        host = []
        if self.slot is not None:
            slot = self.bufs[self.slot]
            host = slot[:self.at] if self.at <= len(slot) else [None] * self.at
        on_card = self.on_card
        self.slot, self.keep_rows, self.on_card = None, False, []
        return host, on_card


class Fence:
    """Marks in the device's queue. ``mark()`` after a unit of work, and
    ``wait(mark)`` blocks until the device has finished it and returns the
    host clock then. On the CPU, where the harness's tests drive it, the work
    is done when the call returns."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return True
        event = torch.cuda.Event()
        event.record()
        return event

    @staticmethod
    def wait(mark) -> float:
        if mark is not True:
            mark.synchronize()
        return time.perf_counter()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_traced(segment, units: int, device: torch.device) -> dict:
    """``segment()``, ``units`` steps or requests, with the program's own
    tracing on for it alone; off and emptied afterwards. What
    ``program_trace.py`` reads: the program's ``snapshot()``, its counters
    counted over the segment (the kernel wrappers' launch counts are always
    on, so their count before it is taken off), the host clock at the
    segment's ends (``t0``, ``t1``) and ``units``."""
    from r2dm_tpu_torch.utils import trace

    sync(device)
    trace.reset()
    before = trace.snapshot()["counters"]
    trace.enable()
    try:
        t0 = time.perf_counter()
        segment()
        sync(device)
        t1 = time.perf_counter()
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.reset()
    counters = {k: v - before.get(k, 0) for k, v in snap["counters"].items()}
    return {"spans": snap["spans"], "counters": counters, "t0": t0, "t1": t1, "units": units}


def free(device: torch.device) -> None:
    """Return the program's freed memory to the card before the reference runs."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


@contextmanager
def reference_precision():
    """float32 matrix products and convolutions in float32, not TF32, for
    the body; the settings as they were afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
