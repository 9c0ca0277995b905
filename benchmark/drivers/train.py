"""Training steps fed by the port's loader, as ``train.py`` composes them.

Traffic keys: ``metric`` (the cell's name of its throughput), ``pool_scans``
(synthetic scans made from the seed, the loader's dataset), ``first_update`` (the AdamW update and step count the run
starts at), ``probe_steps`` and ``profile_steps`` (the traced run's),
``reference_rows`` and ``limits``; the batch and the optimiser's settings are
the configuration's ``training``.

The model is built as the trainer builds it (``build_model``) and loads
the benchmark's weights, the sensor's ray angles in ``coords`` where the
network carries them; ``LiDARUtility`` projects with the same angles. The
state is ``init_train_state`` with ``make_optimizer``'s AdamW and schedule, put at
``first_update`` (the scheduler with ``set_schedule_step``, the step count
the EMA sees alike). A step: the next raw batch from ``DataLoader`` over the
pool (its prefetch thread running), pinned and copied to the card,
``preprocess_batch``, ``step_generator(seed, step)``, ``train_step``. Set-up
runs the first three steps, which the check follows; the window runs steps
until ``seconds`` have passed at a step's end, one step queued ahead.
The throughput (``train_img_per_s`` or a configuration's own name of it) =
batch x steps completed / window seconds.

Correctness, after the window and with the program's state freed: the
reference (``reference/train.py``, fp32, TF32 off) runs the same three steps
from the same weights, on the pool's scans of the batches the loader gave
(``batch``: each of those batches equals the pool's rows it names, exactly)
and the same draws of t and the noise. Compared: the network's output in the
first step (``pred``, the relative L2 over the batch), the first step's loss
(``loss``, the relative gap; the later steps' losses are printed, not
compared: they carry the noise of the updates before them), the first step's
gradient as AdamW holds it after that step (its first moment over 1 - beta1;
``grad``), and the change of the parameters (``update``) and of the EMA
(``ema``) after the three, each by its worst leaf: |norm(ours) -
norm(reference's)| over the larger of the reference's norm of that leaf and
of the median leaf. Leaves whose reference gradient is under 1e-3 of the
median leaf's are left out.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from ..data import ScanPool
from ..reference import diffusion as ref_diff
from ..reference import lidar as ref_lidar
from ..reference.train import BETA1, RefTrainer
from ..roofline import flops
from ..trace import profiled
from ..weights import make_state_dict, reference_net
from .common import (Fence, Outcome, compute_dtype, derive, free, leaf_gap, log, program_config, program_traced,
                     ray_angles, reference_precision, rel_l2, sync)

KEYS = ("depth", "reflectance")


def step_seed(seed: int, step: int) -> int:
    """The trainer's per-step generator seed, from (seed, step) alone."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


def run(ctx) -> Outcome:
    from r2dm_tpu_torch.data import DataLoader, preprocess_batch
    from r2dm_tpu_torch.inference import build_diffusion, build_model
    from r2dm_tpu_torch.lidar import LiDARUtility
    from r2dm_tpu_torch.train import step_generator
    from r2dm_tpu_torch.training import (EMAConfig, init_train_state, make_optimizer, make_train_step,
                                         set_schedule_step)

    tr, cfg, dev = ctx.traffic, ctx.cfg, ctx.device
    if ctx.control not in (None, "fp8"):  # the int8 lane raises under autograd, and bf16 is the step's
        raise ValueError(f"training's control is fp8, the reference in fp8 in the program's place, not {ctx.control!r}")
    tc = cfg["training"]
    B, first = tc["batch_size"], tr["first_update"]
    pcfg = program_config(cfg)
    weights_seed, train_seed = derive(ctx.seed, 1), derive(ctx.seed, 4)
    pool = ScanPool(derive(ctx.seed, 5), tr["pool_scans"], *cfg["resolution"])
    loader_iter = iter(DataLoader(pool, batch_size=B, seed=derive(ctx.seed, 6)))
    sd = make_state_dict(cfg, weights_seed, dev)
    model = build_model(pcfg, dtype=compute_dtype(cfg, dev), device=dev)
    model.load_state_dict(sd)
    names = [n for n, _ in model.named_parameters()]
    lidar_utils = LiDARUtility(tuple(cfg["resolution"]), cfg["depth_format"], cfg["min_depth"], cfg["max_depth"],
                               ray_angles=ray_angles(cfg, dev), data_format="NHWC", device=dev)
    del sd
    diffusion = build_diffusion(pcfg, model)
    optimizer, scheduler = make_optimizer(model.parameters(), pcfg.training)
    state = init_train_state(model, optimizer, scheduler)
    set_schedule_step(scheduler, first)
    state.step = state.updates = first
    train_step = make_train_step(diffusion, optimizer, scheduler,
                                 EMAConfig(beta=pcfg.training.ema_decay, update_every=pcfg.training.ema_update_every))
    pin = dev.type == "cuda"

    def next_raw() -> dict:
        with ctx.spans.span("loader_wait"), record_function("bench.loader"):
            return next(loader_iter)

    def one(trace_call=None):
        """One trainer step; the raw batch's ids and planes and the metrics."""
        raw = next_raw()
        batch = {k: (torch.from_numpy(raw[k]).pin_memory() if pin else torch.from_numpy(raw[k])).to(
            dev, non_blocking=pin) for k in KEYS}
        x_0 = preprocess_batch(lidar_utils, batch, tuple(cfg["resolution"]))
        g = step_generator(train_seed, state.step, dev)
        t = time.perf_counter()
        with record_function("bench.train_step"):
            metrics = train_step(state, x_0, g)
        if trace_call is not None:
            trace_call.append((t, time.perf_counter()))
        return raw, metrics

    if ctx.control == "fp8":
        try:
            return control_fp8(ctx, next_raw, weights_seed, train_seed, pool, first)
        finally:
            loader_iter.close()
    sync(dev)
    log(f"set-up: the model, state and scans at {time.perf_counter() - ctx.t_start:.3f} s")
    # set-up: the three steps the check follows, every shape warmed
    followed, first_pred = [], []
    hook = model.register_forward_hook(lambda module, args, out: first_pred.append(out.detach().clone()))
    for i in range(3):
        raw, m = one()
        hook.remove()
        followed.append({"ids": raw["sample_id"].copy(), "planes": {k: raw[k] for k in KEYS}, "loss": m["loss"]})
        if i == 0:
            # AdamW's first moment, zero where it holds none
            first_moment = [optimizer.state[p].get("exp_avg", torch.zeros_like(p)).clone() for p in model.parameters()]
    after = {"params": [p.detach().clone() for p in model.parameters()],
             "ema": [p.detach().clone() for p in state.ema_model.parameters()]}
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.spans.seconds.clear()
    log(f"set-up {setup_s:.3f} s")

    fence, pending, done = Fence(dev), None, 0
    t0 = time.perf_counter()
    while True:
        one()
        mark = fence.mark()
        if pending is not None:
            t = fence.wait(pending)
            done += 1
            if t - t0 >= ctx.seconds:
                break
        pending = mark
    window_s = t - t0
    fence.wait(pending)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics = {tr["metric"]: B * done / window_s, "setup_s": setup_s}
    log(f"window {window_s:.3f} s, {done} steps of b{B}: {B * done / window_s:.4f} img/s")

    observed = {"loader_wait_s": list(ctx.spans.seconds["loader_wait"])}
    if ctx.trace:
        calls = []
        for _ in range(tr["probe_steps"]):  # the step call's host time against its synchronised wall time
            sync(dev)
            one(calls)
            sync(dev)
            calls[-1] = (calls[-1][0], calls[-1][1], time.perf_counter())
        observed["enqueue_s"] = sum(r - c for c, r, _ in calls)
        observed["step_wall_s"] = sum(e - c for c, _, e in calls)
        n = tr["profile_steps"]
        observed["profile"] = profiled(lambda: [one() for _ in range(n)], (), dev)
        observed["profile_host"] = profiled(lambda: one(), (), dev, host=True)
        observed["window"] = {"seconds": window_s, "units": done, "profile_units": n,
                              "flops_per_unit": 3 * flops.forward_flops(cfg) * B}

        def queued():  # one step queued ahead, as in the window
            pending = None
            for _ in range(n):
                one()
                mark = fence.mark()
                if pending is not None:
                    fence.wait(pending)
                pending = mark
            fence.wait(pending)

        observed["program"] = program_traced(queued, n, dev)
    losses = [float(f["loss"]) for f in followed]
    first_grad = [m / (1.0 - BETA1) for m in first_moment]
    by_name = dict(zip(names, zip(first_grad, after["params"], after["ema"])))
    loader_iter.close()  # stops the loader's prefetch thread
    del model, state, optimizer, scheduler, diffusion, train_step, first_moment, after, first_grad
    free(dev)
    t = time.perf_counter()
    with reference_precision():
        checks = check(ctx, followed, losses, first_pred[0], by_name, weights_seed, train_seed, pool, first)
    log(f"the check took {time.perf_counter() - t:.3f} s")
    return Outcome(attempted=done, failed=0, metrics=metrics, observed=observed, checks=checks, peak=peak)


def reference_steps(ctx, followed, weights_seed, train_seed, pool, first, quant=None):
    """The reference's three steps on the followed batches: (trainer, the
    initial parameters, losses, the first gradient, the network's output in
    the first step)."""
    cfg, dev, tr = ctx.cfg, ctx.device, ctx.traffic
    net = reference_net(cfg).to(dev)
    net.load_state_dict(make_state_dict(cfg, weights_seed, dev))
    if quant:
        net.set_quant(quant)
    tc = cfg["training"]
    trainer = RefTrainer(net, first, tc["lr_warmup_steps"], tc["num_steps"])
    initial = [p.detach().clone() for p in trainer.params]
    losses, first_grad, first_pred = [], None, None
    H, W = cfg["resolution"]
    for i, f in enumerate(followed):
        scans = torch.from_numpy(pool.scans[f["ids"]]).to(dev)
        x_0 = ref_lidar.preprocess(scans[..., 4:5], scans[..., 3:4])
        g = torch.Generator(dev).manual_seed(step_seed(train_seed, first + i))
        t = torch.rand((x_0.shape[0],), generator=g, device=dev)
        noise = torch.randn(x_0.shape, generator=g, device=dev)
        if i == 0:
            with torch.no_grad():
                x_t, lsnr = ref_diff.noised(x_0, t, noise)
                rr = tr["reference_rows"]
                first_pred = torch.cat([net(x_t[j:j + rr], lsnr[j:j + rr]) for j in range(0, len(t), rr)])
        out = trainer.step(x_0, t, noise, tr["reference_rows"])
        trainer.ema_update(first + i)
        losses.append(out["loss"])
        if i == 0:
            first_grad = [g.detach().clone() for g in out["grads"]]
    return trainer, initial, losses, first_grad, first_pred


def control_fp8(ctx, next_raw, weights_seed, train_seed, pool, first) -> Outcome:
    """The control: the reference computed in fp8 in the program's place, on
    the loader's first three batches; no window."""
    followed = []
    for _ in range(3):
        raw = next_raw()
        followed.append({"ids": raw["sample_id"].copy(), "planes": {k: raw[k] for k in KEYS}})
    free(ctx.device)
    with reference_precision():
        trainer, _, losses, first_grad, pred = reference_steps(ctx, followed, weights_seed, train_seed, pool, first,
                                                               "fp8")
    by_name = dict(zip(trainer.names, zip(first_grad, [p.detach().clone() for p in trainer.params],
                                          [e.clone() for e in trainer.ema])))
    del trainer
    free(ctx.device)
    with reference_precision():
        checks = check(ctx, followed, losses, pred, by_name, weights_seed, train_seed, pool, first)
    return Outcome(attempted=3, failed=0, metrics={}, observed={}, checks=checks)


@torch.no_grad()
def _norms_keep(first_grad_ref) -> list:
    norms = [float(torch.linalg.vector_norm(g.double())) for g in first_grad_ref]
    med = float(np.median(norms))
    return [i for i, n in enumerate(norms) if n >= 1e-3 * med]


def check(ctx, followed, losses, pred, by_name, weights_seed, train_seed, pool, first) -> dict:
    tr = ctx.traffic
    batch_gap = 0.0
    for f in followed:
        rows = pool.scans[f["ids"]]
        for k, plane in (("depth", rows[..., 4:5]), ("reflectance", rows[..., 3:4])):
            batch_gap = max(batch_gap, float(np.abs(f["planes"][k] - plane).max()))
    trainer, initial, ref_losses, ref_grad, ref_pred = reference_steps(ctx, followed, weights_seed, train_seed, pool,
                                                                       first)
    keep = _norms_keep(ref_grad)
    ours = [by_name[n] for n in trainer.names]
    with torch.no_grad():
        worst = {
            "grad": leaf_gap([o[0] for o in ours], ref_grad, keep),
            "update": leaf_gap([o[1] - p0 for o, p0 in zip(ours, initial)],
                               [p - p0 for p, p0 in zip(trainer.params, initial)], keep),
            "ema": leaf_gap([o[2] - p0 for o, p0 in zip(ours, initial)],
                            [e - p0 for e, p0 in zip(trainer.ema, initial)], keep),
        }
    gaps = {"batch": batch_gap, "pred": rel_l2(pred, ref_pred),
            "loss": abs(losses[0] - ref_losses[0]) / abs(ref_losses[0]),
            **{k: v for k, (v, _) in worst.items()}}
    gaps = {k: (v if math.isfinite(v) else math.inf) for k, v in gaps.items()}
    log(f"checked 3 steps, {len(keep)} of {len(ref_grad)} leaves: " + ", ".join(f"{k} {v:.6g}" for k, v in gaps.items())
        + "; worst leaves " + ", ".join(f"{k} {trainer.names[i]}" for k, (_, i) in worst.items())
        + f"; losses {losses} against {ref_losses}")
    return {k: (v, tr["limits"][k]) for k, v in gaps.items()}
