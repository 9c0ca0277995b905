"""Train R2DM with the PyTorch port (config H by default).

    python -m r2dm_tpu_torch.train --data.dataset synthetic --training.num_steps 200
    python -m r2dm_tpu_torch.train --device cpu --data.dataset synthetic ...   # on the CPU

The counterpart of the repo's ``train.py`` (reference train.py:37-318): the
nested ``--data.x/--model.y/--diffusion.z/--training.w`` flags,
``training_config.json``, the model at bf16 compute with fp32 parameters and
fp32 diffusion maths (on CUDA ``mixed_precision`` must be bf16, the kernels'
type), AdamW + cosine warmup + global-norm clip, the EMA,
``metrics.jsonl`` every 50 steps and at step 1, EMA sample panels every
``steps_save_image`` steps (256 DDPM steps), a msgpack checkpoint in the JAX
package's layout every ``steps_save_model`` steps and at the end, resume
from ``--training.resume``, and SIGTERM/SIGINT: finish the step, write the
checkpoint, exit 0. ``--training.profile_dir`` writes a ``torch.profiler``
trace of steps 10-15 with the program's spans on (``utils/trace.py``), so
the train step's phases, the network's forwards and the loader's batches
show beside the kernels. ``steps_per_sec`` in ``metrics.jsonl`` is the rate
of the steps since the previous line, timed from the end of that step (after
its panels and checkpoint); a panel or checkpoint at a step with no line
falls in the next line's interval. On CUDA every train step runs both
hand-written kernels forward and the ring-conv kernel backward.
``--training.gradient_accumulation_steps`` and ``--training.grad_bf16`` are
the JAX trainer's (``training/step.py``). ``--model.architecture refinenet``
trains the LiDARGen RefineNet (plain PyTorch, no hand-written kernel); as
the JAX trainer does, its ``coords`` buffer is set to the sensor's grid of
``model_coords`` like the EfficientUNet's (train.py:219-225).

On N cards, one process per card (the data axis of ``parallel/``):

    torchrun --nproc_per_node N -m r2dm_tpu_torch.train --data.dataset synthetic ...

``batch_size_train`` is the global batch: each rank loads its rows of every
global batch (``DataLoader(process_index, process_count)``) and draws the
global batch's timesteps and noise from the step's generator, keeping its
rows, so the loss sees the numbers one process would. The model runs under
``DistributedDataParallel`` (``broadcast_buffers=False``: the coordinates
and FIR taps are constants); the EMA, the checkpoint and the panels use the
unwrapped module. Rank 0 alone writes ``training_config.json``,
``metrics.jsonl`` (its loss the global batch's mean), the panels and the
checkpoint. The ranks agree to stop (a signal on any of them) at one step
boundary through an all-reduce of the flag on the gloo side group, every
step: the counterpart of the JAX trainer's ``consensus_any``. With dropout
> 0 every rank draws its dropout masks from the same generator after the
global draws, so the masks are not a single process's.

``--training.mesh_shape D,W`` on D·W processes adds the width axis (the JAX
trainer's GSPMD sharding of W, r2dm_tpu/training/step.py:117-128): rank
``d*W + w`` holds columns ``[w*Wimg/W, (w+1)*Wimg/W)`` of its data group's
rows (``parallel/mesh.py``). The W ranks of a data group load the same rows
(``process_index=world.data_index``); x_0 and the noise are the whole
image's, drawn as one rank draws them, and cut to the rank's columns; the
timesteps are shared, and so are the dropout masks, drawn for the whole
image and cut alike. The model runs ``set_width_shard`` on the world (the
halo'd conv and the split GroupNorm forward and backward, the differentiable
halo exchange and key/value gather); each rank's loss and gradients are its
columns' share, and instead of DDP the step sums the gradients over the
world and divides by D (``training/step.py``). The EMA copy stays
whole-image, taken before the model is sharded, so rank 0 samples its
panels alone. The logged loss is the global batch's: a width sum, then a
data mean.

Options of the JAX trainer that this one leaves out or ignores:
- ``max_host_rss_gb``: ignored; the JAX trainer restarts itself to escape a
  TPU runtime's host-memory retention, which has no counterpart here;
- ``width_merge_l1``: passed to ``build_model`` for an EfficientUNet, as
  the JAX trainer does; the network then runs level 1 on the NHWC kernels
  (``EfficientUNet``), with the same parameters, math and checkpoints;
- ``mesh_shape``: (N,) or (D, W) must multiply to the world size (one
  process per card), where the JAX trainer takes a mesh over its devices;
- ``gn_bf16``: the JAX package computes the GroupNorm FMA + SiLU pass in
  bf16 when it is set (the default); the port's kernel computes it in fp32
  and rounds once, about one bf16 ulp apart (ROADMAP, North star).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import signal
import sys
import time

import numpy as np
import torch

from . import config as config_lib
from . import parallel
from .checkpoint import load_checkpoint, load_opt_state, save_checkpoint
from .data import DataLoader, make_dataset, preprocess_batch
from .diffusion.base import normal
from .inference import build_diffusion, build_model, count_parameters, model_coords
from .lidar import LiDARUtility
from .models.layers import set_width_shard
from .training import EMAConfig, init_train_state, make_optimizer, make_train_step, schedule_lr, set_schedule_step
from .utils import trace
from .utils.logging import MetricLogger, save_image_panels
from .utils.weights import from_jax

CHECKPOINT = "checkpoint.msgpack"
SAMPLE_STEPS = 256  # the EMA panels' DDPM chain, as in the JAX trainer


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one train step, seeded from (seed, step) alone, as
    ``jax.random.fold_in(key(seed), step)`` is: a resumed run draws what an
    uninterrupted one would."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state))


def _device_batches(loader: DataLoader, keys: list, device: torch.device):
    """The loader's batches, the planes the step uses only, on ``device``:
    copied from pinned memory without blocking the host on a CUDA card."""
    pin = device.type == "cuda"
    it = iter(loader)
    try:
        for raw in it:
            yield {
                k: (torch.from_numpy(raw[k]).pin_memory() if pin else torch.from_numpy(raw[k])).to(device, non_blocking=pin)
                for k in keys
            }
    finally:
        it.close()  # stops the loader's prefetch thread


# DDP's buffer broadcast before every forward, off: the coordinates and FIR
# taps are constants (PyTorch 2.13 renames broadcast_buffers)
_NO_BUFFER_SYNC = ({"forward_sync_buffers": False}
                   if "forward_sync_buffers" in inspect.signature(torch.nn.parallel.DistributedDataParallel).parameters
                   else {"broadcast_buffers": False})


def _rank_draws(diffusion, generator: torch.Generator, global_batch: int, x_0: torch.Tensor,
                world: parallel.World):
    """This rank's rows of the global batch's timesteps and noise, drawn in
    the order ``diffusion.loss`` draws them; the noise of the whole image
    (``x_0``'s), cut to the rank's columns under a width axis."""
    steps = diffusion.sample_timesteps(global_batch, generator, x_0.device)
    noise = normal(generator, (global_batch, *x_0.shape[1:]), x_0.device)
    rows = slice(world.data_index * x_0.shape[0], (world.data_index + 1) * x_0.shape[0])
    return steps[rows], parallel.shard_columns(noise[rows], world)


def resume(state, path: str) -> int:
    """Load weights, EMA weights, AdamW state (and under accumulation the
    running mean) and step from a checkpoint of this trainer or of the JAX
    package's; returns the step."""
    ckpt = load_checkpoint(path)
    arch = state.model.architecture
    state.model.load_state_dict(from_jax(ckpt["weights"], arch))
    state.ema_model.load_state_dict(from_jax(ckpt["ema_weights"] or ckpt["weights"], arch))
    state.step = ckpt["global_step"]
    if ckpt["opt_state"] is not None:
        load_opt_state(state, ckpt["opt_state"])
    elif state.accumulation_steps > 1:
        raise ValueError(f"{path} holds no optimizer state: an accumulating run cannot resume from it")
    else:
        state.updates = state.step
    set_schedule_step(state.scheduler, state.updates)
    return state.step


def train(cfg: config_lib.Config, device="cuda"):
    """Run the training loop on this process's rank of the data axis (the
    whole of it without a process group); returns the final ``TrainState``."""
    world = parallel.init(device, mesh=cfg.training.mesh_shape)
    try:
        return _train(cfg, world)
    finally:
        world.close()


def _train(cfg: config_lib.Config, world: parallel.World):
    device = world.device
    tcfg = cfg.training
    parallel.any_rank(world, False)  # the side group's first round trip, while the ranks are aligned
    is_main = world.is_main
    out_dir = tcfg.output_dir
    if is_main:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "training_config.json"), "w") as f:
            json.dump(config_lib.asdict(cfg), f, indent=2)  # cf. reference train.py:60-64

    # ---------------------------------------------------------------- model
    channels = int(cfg.data.train_depth) + int(cfg.data.train_reflectance)
    dtype = torch.bfloat16 if tcfg.mixed_precision == "bf16" else None
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(tcfg.seed)  # the initial weights from the seed
        model = build_model(cfg, dtype=dtype, device="cpu", width_merge_l1=(
            tcfg.width_merge_l1 and cfg.model.architecture == "efficient_unet"))
    coords = model_coords(cfg)
    model.coords.copy_(torch.from_numpy(np.ascontiguousarray(coords.transpose(2, 0, 1)[None])))
    model = model.to(device)
    diffusion = build_diffusion(cfg, model)
    lidar_utils = LiDARUtility(
        resolution=tuple(cfg.data.resolution), depth_format=cfg.data.depth_format,
        min_depth=cfg.data.min_depth, max_depth=cfg.data.max_depth,
        ray_angles=coords, data_format="NHWC", device=device,
    )
    if is_main:
        print(f"number of parameters: {count_parameters(model) / 1e6:.2f}M")  # cf. reference train.py:111-112

    # ------------------------------------------------- optimizer and resume
    optimizer, scheduler = make_optimizer(model.parameters(), tcfg)
    state = init_train_state(model, optimizer, scheduler, tcfg.gradient_accumulation_steps)
    start_step = 0
    if tcfg.resume:
        start_step = resume(state, tcfg.resume)
        if is_main:
            print(f"resumed from {tcfg.resume} at step {start_step}")
    # after the EMA copy, which stays whole-image and out of the wrapper
    width = world if parallel.sharded(world) else None
    set_width_shard(model, width)
    ddp = None
    if world.distributed and width is None:
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None, **_NO_BUFFER_SYNC)
    train_step = make_train_step(
        diffusion, optimizer, scheduler, EMAConfig(beta=tcfg.ema_decay, update_every=tcfg.ema_update_every),
        grad_dtype=torch.bfloat16 if tcfg.grad_bf16 else None, ddp=ddp, width=width,
    )
    ema_diffusion = build_diffusion(cfg, state.ema_model)

    # ----------------------------------------------------------------- data
    dataset = make_dataset(cfg.data.dataset, cfg.data.data_root, "train", cfg.data.projection,
                           cache_dir=os.path.join(out_dir, "cache") if cfg.data.data_root else None)
    loader = DataLoader(dataset, batch_size=tcfg.batch_size_train, seed=tcfg.seed, process_index=world.data_index,
                        process_count=world.data_size)
    keys = (["depth"] if cfg.data.train_depth else []) + (["reflectance"] if cfg.data.train_reflectance else [])
    batches = _device_batches(loader, keys, device)
    logger = MetricLogger(out_dir, enabled=is_main)

    # ----------------------------------------------------- preemption guard
    # finish the step in flight, write the checkpoint and exit 0; the
    # previous handlers come back on every way out, and a second signal
    # acts as it did before
    preempted = {"signal": None}
    prev_handlers = {}

    def on_signal(signum, frame):
        preempted["signal"] = signum
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        print(f"received signal {signum}: checkpointing at the next step boundary and exiting "
              f"(repeat the signal to abort){f' [rank {world.rank}]' if world.distributed else ''}", flush=True)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, on_signal)
        except ValueError:  # not the main thread: no guard
            pass

    def write_checkpoint() -> str:
        return save_checkpoint(os.path.join(out_dir, CHECKPOINT), config_lib.asdict(cfg), state)

    profiler = None
    t0 = time.time()
    t_log, step_log = t0, start_step  # the interval that steps_per_sec covers
    global_step = start_step
    stopped = False
    try:
        while global_step < tcfg.num_steps:
            if parallel.any_rank(world, preempted["signal"] is not None):
                stopped = True
                break
            batch = next(batches)
            if tcfg.profile_dir and is_main and global_step - start_step == 10:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
                trace.enable()
            x_0 = preprocess_batch(
                lidar_utils, batch, tuple(cfg.data.resolution), cfg.data.train_depth, cfg.data.train_reflectance
            )
            g = step_generator(tcfg.seed, global_step, device)
            if world.distributed:
                steps, noise = _rank_draws(diffusion, g, tcfg.batch_size_train, x_0, world)
                metrics = train_step(state, parallel.shard_columns(x_0, world), g, steps=steps, noise=noise)
            else:
                metrics = train_step(state, x_0, g)
            global_step += 1
            if profiler is not None and global_step - start_step == 15:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                trace.disable()
                profiler.stop()
                os.makedirs(tcfg.profile_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(tcfg.profile_dir, "trace.json"))
                profiler = None
                print(f"profile trace written to {tcfg.profile_dir}")

            if global_step % 50 == 0 or global_step == 1:
                if world.distributed:  # the global batch's loss: the width shares summed, the data mean
                    metrics["loss"] = metrics["loss"].clone()
                    torch.distributed.all_reduce(metrics["loss"])
                    metrics["loss"] /= world.data_size
                m = {k: float(v) for k, v in metrics.items()}
                m["lr"] = schedule_lr(scheduler, global_step)
                m["steps_per_sec"] = (global_step - step_log) / (time.time() - t_log)
                logger.log(global_step, m)  # cf. reference train.py:273-277
                step_log = global_step

            if global_step % tcfg.steps_save_image == 0 and is_main:
                g = step_generator(9, global_step, device)
                samples = ema_diffusion.sample(min(tcfg.batch_size_eval, 8), SAMPLE_STEPS, generator=g)
                save_image_panels(out_dir, global_step, samples, lidar_utils, channels)  # cf. train.py:282-289

            if global_step % tcfg.steps_save_model == 0 and is_main:
                write_checkpoint()
            if step_log == global_step:
                t_log = time.time()

        if is_main:
            path = write_checkpoint()
            if stopped:
                print(f"preempted at step {global_step} (signal {preempted['signal'] or 'on another rank'}); "
                      f"resume with --training.resume {path}")
            else:
                print(f"done: {global_step} steps in {time.time() - t0:.0f}s -> {out_dir}")
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if profiler is not None:
            trace.disable()
            profiler.stop()
        batches.close()
        logger.close()
    return state


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    cfg, ns = config_lib.parse_cli(argv, parser)
    train(cfg, ns.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
