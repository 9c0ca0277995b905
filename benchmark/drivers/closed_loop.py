"""A closed loop of one client: each request asks for ``batch`` fresh scans
and waits for them; the next is sent when the previous one returns.

Traffic keys: ``batch``, ``steps``, ``mode`` (a Gaussian sampler of
``DDPM.sample``), ``warmup_requests``, ``check_requests`` and
``check_within`` (requests drawn from the seed among the window's first
``check_within``), ``profile_requests``, ``reference_rows`` and ``limits``.

Request i is ``DDPM.sample(batch, steps, mode, seeds=<batch seeds from (run
seed, 3, i)>)``, then ``sample_and_save.postprocess`` turns the scans into
depth, points and reflectance, copied to the host: what ``generate`` and
``sample_and_save`` hand their user. Its latency is the host clock from the
call to the points on the host. Requests are sent while ``seconds`` have not
passed; the last one is waited for. ``request_p90_ms`` is the nearest-rank
90th percentile of all of them, a failed one counting as infinitely late.

Correctness, after the window: for each checked request a forward hook kept
the network's input and output at every step (copied to pinned host memory
as they come). The reference checks x_T against its draws from the seeds
(``x_T``, exact), the eps of every step on the program's x_t (``eps``),
every step's output against the reference's step from the program's x_t and
eps (``step``: against the next step's input, the last against the returned
scans), and the points of the returned scans (``points``, the relative L2
of the program's host copy against the reference's conversion).

The eps control is the architecture module's (``CONTROLS``): ``--control
int8`` runs the network on the program's own int8 lane, ``--control fp8`` puts
the reference network's eps in fp8 in the program's place; ``--control
bf16`` takes the steps' outputs and the points from the reference in
bfloat16 in place of the program's (their control).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from ..reference import diffusion as ref_diff
from ..reference import lidar as ref_lidar
from ..roofline import flops
from ..trace import percentile, profiled
from ..weights import make_state_dict, reference_net
from .common import (Outcome, Recorder, compute_dtype, derive, free, log, program_config, program_control,
                     program_traced, ray_angles, reference_eps, reference_precision, rel_l2, sync)


def run(ctx) -> Outcome:
    from dataclasses import asdict

    from r2dm_tpu_torch.inference import setup_model
    from r2dm_tpu_torch.sample_and_save import postprocess

    tr, cfg, dev = ctx.traffic, ctx.cfg, ctx.device
    B, S, mode = tr["batch"], tr["steps"], tr["mode"]
    weights_seed = derive(ctx.seed, 1)
    ddpm, lidar_utils, _ = setup_model(
        {"cfg": asdict(program_config(cfg)), "ema_weights": make_state_dict(cfg, weights_seed, dev)},
        dtype=compute_dtype(cfg, dev), device=dev)
    program_control(ctx, ddpm.model)
    rng = np.random.default_rng(derive(ctx.seed, 2))
    checked = sorted(int(i) for i in rng.choice(tr["check_within"], tr["check_requests"], replace=False))
    recorder = Recorder(ddpm.model, len(checked), S, (B, *ddpm.sampling_shape), dev)

    def seeds(i: int, stream: int = 3) -> list:
        """Request i's seeds: stream 3 the window's, 7 set-up's, 8 the
        profiled windows', 9 the program-traced segment's."""
        return [derive(ctx.seed, stream, i, j) for j in range(B)]

    def request(i: int, stream: int = 3):
        keep = stream == 3 and i in checked
        if keep:
            recorder.open(checked.index(i))
        try:
            with record_function("bench.sample"):
                x = ddpm.sample(B, S, mode=mode, seeds=seeds(i, stream))
            with record_function("bench.points"):
                points = postprocess(x, lidar_utils).cpu().numpy()
        finally:
            kept = recorder.close()[0] if keep else None
        return (i, kept, x, points) if keep else None

    sync(dev)
    log(f"set-up: the model at {time.perf_counter() - ctx.t_start:.3f} s")
    for w in range(tr["warmup_requests"]):  # set-up: every shape of a request warmed
        request(w, stream=7)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    log(f"set-up {setup_s:.3f} s")

    latencies, failed, records = [], 0, []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < ctx.seconds:
        t = time.perf_counter()
        try:
            out = request(i)
        except RuntimeError as e:  # a request that fails counts as missing the tail
            log(f"request {i} failed: {e}")
            failed += 1
            latencies.append(math.inf)
        else:
            latencies.append(time.perf_counter() - t)
            if out is not None:
                records.append(out)
        i += 1
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    p90 = percentile(latencies, 90) * 1e3
    metrics = {"request_p90_ms": p90, "setup_s": setup_s}
    log(f"window {window_s:.3f} s, {len(latencies)} requests, p50 {percentile(latencies, 50) * 1e3:.3f} ms, "
        f"p90 {p90:.3f} ms, max {max(latencies) * 1e3:.3f} ms; the first five "
        + ", ".join(f"{v * 1e3:.1f}" for v in latencies[:5]) + " ms")

    observed = {}
    if ctx.trace:
        n = tr["profile_requests"]
        observed["profile"] = profiled(lambda: [request(j, stream=8) for j in range(n)], (), dev)
        observed["profile_host"] = profiled(lambda: request(n, stream=8), (), dev, host=True)
        observed["window"] = {"seconds": window_s, "units": len(latencies) - failed, "profile_units": n,
                              "flops_per_unit": flops.forward_flops(cfg) * B * S}
        observed["denoising_steps"] = S * n
        observed["program"] = program_traced(lambda: [request(j, stream=9) for j in range(n)], n, dev)
    recorder.handle.remove()
    del ddpm, recorder
    free(dev)

    t = time.perf_counter()
    with reference_precision():
        checks = check(ctx, records, weights_seed, seeds, ray_angles(cfg, dev))
    log(f"the check took {time.perf_counter() - t:.3f} s")
    return Outcome(attempted=len(latencies), failed=failed, metrics=metrics, observed=observed, checks=checks,
                   peak=peak)


@torch.no_grad()
def check(ctx, records, weights_seed, seeds, angles) -> dict:
    tr, cfg, dev = ctx.traffic, ctx.cfg, ctx.device
    sync(dev)
    net = reference_net(cfg).to(dev)
    net.load_state_dict(make_state_dict(cfg, weights_seed, dev))
    net.eval()
    H, W = cfg["resolution"]
    C = cfg["in_channels"]
    ts = ref_diff.boundary_times(tr["steps"])
    step = ref_diff.ddim_step if tr["mode"] == "ddim" else None
    if step is None:
        raise ValueError("the closed loop checks deterministic (ddim) requests")
    gaps = {"x_T": 0.0, "eps": 0.0, "step": 0.0, "points": 0.0}
    low = torch.bfloat16 if ctx.control == "bf16" else None
    if not records:
        gaps["step"] = math.inf  # no checked request came back
    for i, kept, x, points in records:
        if len(kept) != tr["steps"] or kept[0] is None:
            gaps["step"] = math.inf
            continue
        x_T_ref = torch.stack([torch.randn((H, W, C), generator=torch.Generator(dev).manual_seed(s), device=dev)
                               for s in seeds(i)])
        gaps["x_T"] = max(gaps["x_T"], float((kept[0][0].to(dev) - x_T_ref).abs().max()))
        for k, (x_in, _, eps) in enumerate(kept):
            x_in, eps = x_in.to(dev), eps.to(dev)
            cond = ref_diff.logsnr(torch.full((x_in.shape[0],), float(ts[k]), device=dev))
            eps_ref = reference_eps(net, x_in, cond, tr["reference_rows"])
            eps_ours = eps
            if ctx.control == "fp8":  # the control: the reference's eps in fp8 in the program's place
                eps_ours = reference_eps(net, x_in, cond, tr["reference_rows"], "fp8")
            x_next = kept[k + 1][0].to(dev) if k + 1 < len(kept) else x.to(dev).permute(0, 2, 3, 1)
            if low is not None:  # the control: the reference's step in the precision below in the program's place
                x_next = step(x_in, eps, float(ts[k]), float(ts[k + 1]), low)
            gaps["eps"] = max(gaps["eps"], rel_l2(eps_ours, eps_ref))
            gaps["step"] = max(gaps["step"], rel_l2(x_next, step(x_in, eps, float(ts[k]), float(ts[k + 1]))))
        ours = torch.from_numpy(points).to(dev)
        if low is not None:
            ours = ref_lidar.postprocess(x.to(dev), angles, low)
        gaps["points"] = max(gaps["points"], rel_l2(ours, ref_lidar.postprocess(x.to(dev), angles)))
    gaps = {k: (v if math.isfinite(v) else math.inf) for k, v in gaps.items()}
    log(f"checked {len(records)} requests: " + ", ".join(f"{k} {v:.6g}" for k, v in gaps.items()))
    return {k: (v, tr["limits"][k]) for k, v in gaps.items()}
