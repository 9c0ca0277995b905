"""Batch sampling: one long chain of ``batch`` images, its steps timed.

Traffic keys: ``batch``, ``steps`` (the chain's length), ``mode`` (``ddpm``
or ``ddim``), ``check_rows`` (rows whose eps the reference computes again
after set-up's step, where it computes every row's),
``check_steps`` and ``check_within`` (that many steps drawn from the seed
among the window's first ``check_within``, besides set-up's first step and the
window's last), ``profile_steps``, ``reference_rows`` (rows of the reference's
forward at once) and ``limits``.

The program is set up as a user loads a checkpoint (``setup_model`` on a
dict of the benchmark's weights), and the chain is the port's own loop:
x_T drawn by the port from one generator per image (image i of chain c from
seed (run seed, 3, c, i)), then ``sample_segment`` one step at a time, as
``DDPM.sample`` runs it in segments. Set-up draws chain 0's x_T and runs its
first step. The window then runs steps until ``seconds`` have passed at a
step's end, keeping one step queued ahead; a chain that ends starts the next
one with new seeds. ``sample_img_per_s`` = batch x steps completed /
(chain steps x window seconds).

Correctness, after the window: the reference (``reference/``, fp32) follows
the program step by step from the program's own state, since a free chain
amplifies any rounding at t = 1 (x_0 = (x - sigma eps) / alpha, 1 / alpha =
1800). Checked: x_T of every row against the reference's draws from the
seeds (``x_T``, exact); the network's eps on the program's x_t against the
reference network's, on every row at set-up's step and on ``check_rows``
rows at the drawn steps and the window's last (``eps``, the worst relative L2
over a block of ``check_rows`` rows); and the step's
output against the reference's step from the program's x_t and eps with the
noise drawn again from the seeds (``step``), on every row at set-up's step
and the drawn steps (copied to pinned host memory as the window runs) and on
the check rows at the last.

The eps control is the architecture module's (``CONTROLS``): ``--control
int8`` runs the network on the program's own int8 lane, ``--control fp8`` puts
the reference network's eps in fp8 in the program's place;
``--control bf16`` takes the step's output from the reference's step in
bfloat16 in place of the program's (the step control).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import manifest
from ..reference import diffusion as ref_diff
from ..roofline import flops
from ..trace import profiled
from ..weights import make_state_dict, reference_net
from .common import (Fence, Outcome, Recorder, compute_dtype, derive, free, log, program_config, program_control,
                     program_traced, reference_eps, reference_precision, rel_l2, sync)


def run(ctx) -> Outcome:
    from dataclasses import asdict

    from r2dm_tpu_torch.diffusion.base import normal
    from r2dm_tpu_torch.inference import setup_model, setup_rng

    tr, cfg, dev = ctx.traffic, ctx.cfg, ctx.device
    B, N, mode = tr["batch"], tr["steps"], tr["mode"]
    weights_seed = derive(ctx.seed, 1)
    ddpm, _, _ = setup_model({"cfg": asdict(program_config(cfg)), "ema_weights": make_state_dict(cfg, weights_seed, dev)},
                             dtype=compute_dtype(cfg, dev), device=dev)
    program_control(ctx, ddpm.model)
    diff = ddpm.diffusion
    rng = np.random.default_rng(derive(ctx.seed, 2))
    rows = sorted(int(r) for r in rng.choice(B, tr["check_rows"], replace=False))
    drawn = {int(k) for k in rng.choice(np.arange(tr["check_within"]), tr["check_steps"], replace=False)}
    shape = (B, *diff.sampling_shape)
    recorder = Recorder(ddpm.model, len(drawn) + 1, 1, shape, dev, rows)
    out_host = [torch.empty(shape, dtype=torch.float32, pin_memory=dev.type == "cuda") for _ in range(len(drawn) + 1)]
    ts = torch.linspace(1.0, 0.0, N + 1, dtype=torch.float32, device=dev)

    def chain_seeds(c: int) -> list:
        return [derive(ctx.seed, 3, c, i) for i in range(B)]

    chain = {"c": 0, "k": 0, "gens": setup_rng(chain_seeds(0), dev)}
    x = normal(chain["gens"], shape, dev)
    x_T = x.clone()

    def step(keep: bool, slot=None):
        """One step of the running chain; with ``keep`` its (chain, step,
        check rows of its input, eps and output, host slot of every row)."""
        nonlocal x
        if chain["k"] == N:  # a new chain, new seeds
            chain.update(c=chain["c"] + 1, k=0, gens=setup_rng(chain_seeds(chain["c"] + 1), dev))
            x = normal(chain["gens"], shape, dev)
        k = chain["k"]
        if keep:
            recorder.open(slot, rows=True)
        with record_function("bench.step"):
            x = diff.sample_segment(x, ts[k:k + 2], mode, 0.0, chain["gens"])
        chain["k"] += 1
        if not keep:
            return None
        (x_in, eps), = recorder.close()[1]
        if slot is not None:
            out_host[slot].copy_(x, non_blocking=True)
        return chain["c"], k, x_in, eps, x[rows].clone(), slot

    slots = {j: n + 1 for n, j in enumerate(sorted(drawn))}  # host slot 0 is set-up's step
    sync(dev)
    log(f"set-up: the model at {time.perf_counter() - ctx.t_start:.3f} s")
    records = [step(True, 0)]  # set-up: chain 0's first step, every shape warmed
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    log(f"set-up {setup_s:.3f} s")

    fence, pending, done, last = Fence(dev), None, 0, []
    t0 = time.perf_counter()
    while True:
        j = done + (pending is not None)  # the window's index of the step now enqueued
        last = [last[-1] if last else None, step(True, slots.get(j))]  # the step in flight and the one before
        mark = fence.mark()
        if pending is not None:
            t = fence.wait(pending)
            done += 1
            if done - 1 in drawn:
                records.append(last[0])
            if t - t0 >= ctx.seconds:
                break
        pending = mark
    window_s = t - t0
    records.append(last[0])  # the window's last completed step
    fence.wait(pending)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics = {"sample_img_per_s": B * done / (N * window_s), "setup_s": setup_s}
    log(f"window {window_s:.3f} s, {done} steps of b{B}: {metrics['sample_img_per_s']:.4f} img/s")

    observed = {}
    if ctx.trace:
        n = tr["profile_steps"]
        observed["profile"] = profiled(lambda: [step(False) for _ in range(n)], (), dev)
        observed["profile_host"] = profiled(lambda: step(False), manifest.architecture(cfg).wrapped_work(), dev,
                                            host=True)
        observed["window"] = {"seconds": window_s, "units": done, "profile_units": n,
                              "flops_per_unit": flops.forward_flops(cfg) * B}
        observed["program"] = program_traced(lambda: [step(False) for _ in range(n)], n, dev)
    recorder.handle.remove()
    host = [(b[0][0], b[0][2], out) for b, out in zip(recorder.bufs, out_host)]  # x_t, eps, the step's output
    del ddpm, diff, x, recorder
    free(dev)

    t = time.perf_counter()
    with reference_precision():
        checks = check(ctx, records, host, rows, x_T, weights_seed, chain_seeds, ts_len=N)
    log(f"the check took {time.perf_counter() - t:.3f} s")
    return Outcome(attempted=done, failed=0, metrics=metrics, observed=observed, checks=checks, peak=peak)


@torch.no_grad()
def check(ctx, records, host, rows, x_T, weights_seed, chain_seeds, ts_len) -> dict:
    tr, cfg, dev = ctx.traffic, ctx.cfg, ctx.device
    net = reference_net(cfg).to(dev)
    net.load_state_dict(make_state_dict(cfg, weights_seed, dev))
    net.eval()
    H, W = cfg["resolution"]
    C = cfg["in_channels"]
    ts = ref_diff.boundary_times(ts_len)
    low = torch.bfloat16 if ctx.control == "bf16" else None

    def noise(c: int, k: int, which) -> torch.Tensor:
        """Draw k of chain c's generators (0: x_T, k + 1: step k's noise)."""
        out = []
        for r in which:
            g = torch.Generator(dev).manual_seed(chain_seeds(c)[r])
            for _ in range(k):
                torch.randn((H, W, C), generator=g, device=dev)
            out.append(torch.randn((H, W, C), generator=g, device=dev))
        return torch.stack(out)

    def ref_step(c, k, x_in, eps, which, dtype=torch.float32):
        if tr["mode"] == "ddpm":
            return ref_diff.ddpm_step(x_in, eps, float(ts[k]), float(ts[k + 1]), noise(c, k + 1, which), dtype)
        return ref_diff.ddim_step(x_in, eps, float(ts[k]), float(ts[k + 1]), dtype)

    everyone = range(x_T.shape[0])
    gaps = {"x_T": float((x_T - noise(0, 0, everyone)).abs().max()), "eps": 0.0, "step": 0.0}
    seen = set()
    for c, k, x_in, eps, x_out, slot in records:
        if (c, k) in seen:
            continue
        seen.add((c, k))
        if slot is None:  # the check rows
            which, x_in_all, eps_all, x_out_all = rows, x_in, eps, x_out
        else:  # every row, from the host copies
            which = everyone
            x_in_all, eps_all, x_out_all = (t.to(dev) for t in host[slot])
        # the network's eps: every row at set-up's step, in blocks of as many rows as are checked elsewhere
        e_in, e_ours = (x_in_all, eps_all) if slot == 0 else (x_in, eps)
        rr, n = tr["reference_rows"], len(rows)
        cond = ref_diff.logsnr(torch.full((len(e_in),), float(ts[k]), device=dev))
        eps_ref = reference_eps(net, e_in, cond, rr)
        if ctx.control == "fp8":  # the control: the reference's eps in fp8 in the program's place
            e_ours = reference_eps(net, e_in, cond, rr, "fp8")
        for i in range(0, len(e_in), n):
            gaps["eps"] = max(gaps["eps"], rel_l2(e_ours[i:i + n], eps_ref[i:i + n]))
        if low is not None:  # the control: the reference's step in the precision below in the program's place
            x_out_all = ref_step(c, k, x_in_all, eps_all, which, low)
        gaps["step"] = max(gaps["step"], rel_l2(x_out_all, ref_step(c, k, x_in_all, eps_all, which)))
    gaps = {k: (v if math.isfinite(v) else math.inf) for k, v in gaps.items()}
    log(f"checked {len(seen)} steps ({sum(r[5] is not None for r in records)} of every row), every row's eps at "
        f"set-up's step and {len(rows)} rows' at the others: "
        + ", ".join(f"{k} {v:.6g}" for k, v in gaps.items()))
    return {k: (v, tr["limits"][k]) for k, v in gaps.items()}
