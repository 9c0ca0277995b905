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
trace of steps 10-15. On CUDA every train step runs both hand-written
kernels forward and the ring-conv kernel backward.

Options of the JAX trainer that this one leaves out or ignores:
- ``max_host_rss_gb``: ignored; the JAX trainer restarts itself to escape a
  TPU runtime's host-memory retention, which has no counterpart here;
- ``width_merge_l1``: ignored; a TPU-only layout, an exact re-lowering of
  the same network;
- ``mesh_shape`` over more than one device: raises (ROADMAP queue 1,
  parallelism);
- ``gradient_accumulation_steps > 1`` and ``grad_bf16``: raise
  (``training/optim.py``);
- ``gn_bf16``: the JAX package computes the GroupNorm FMA + SiLU pass in
  bf16 when it is set (the default); the port's kernel computes it in fp32
  and rounds once, about one bf16 ulp apart (ROADMAP, North star).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import sys
import time

import numpy as np
import torch

from . import config as config_lib
from .checkpoint import load_checkpoint, load_opt_state, save_checkpoint
from .data import DataLoader, make_dataset, preprocess_batch
from .inference import build_diffusion, build_model, count_parameters, model_coords
from .lidar import LiDARUtility
from .training import EMAConfig, init_train_state, make_optimizer, make_train_step, set_schedule_step
from .utils.logging import MetricLogger, save_image_panels
from .utils.weights import state_dict_from_jax

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


def _check_supported(cfg: config_lib.Config) -> None:
    mesh = cfg.training.mesh_shape
    if mesh is not None and math.prod(mesh) > 1:
        raise NotImplementedError(
            f"training.mesh_shape={mesh}: training over more than one device is not ported yet "
            "(ROADMAP.md queue 1, parallelism)"
        )


def resume(state, path: str) -> int:
    """Load weights, EMA weights, AdamW state and step from a checkpoint of
    this trainer or of the JAX package's; returns the step."""
    ckpt = load_checkpoint(path)
    state.model.load_state_dict(state_dict_from_jax(ckpt["weights"]))
    state.ema_model.load_state_dict(state_dict_from_jax(ckpt["ema_weights"] or ckpt["weights"]))
    if ckpt["opt_state"] is not None:
        load_opt_state(state, ckpt["opt_state"])
    state.step = ckpt["global_step"]
    set_schedule_step(state.scheduler, state.step)
    return state.step


def train(cfg: config_lib.Config, device="cuda"):
    """Run the training loop; returns the final ``TrainState``."""
    device = torch.device(device)
    _check_supported(cfg)
    tcfg = cfg.training
    out_dir = tcfg.output_dir
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "training_config.json"), "w") as f:
        json.dump(config_lib.asdict(cfg), f, indent=2)  # cf. reference train.py:60-64

    # ---------------------------------------------------------------- model
    channels = int(cfg.data.train_depth) + int(cfg.data.train_reflectance)
    dtype = torch.bfloat16 if tcfg.mixed_precision == "bf16" else None
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(tcfg.seed)  # the initial weights from the seed
        model = build_model(cfg, dtype=dtype, device="cpu")
    coords = model_coords(cfg)
    model.coords.copy_(torch.from_numpy(np.ascontiguousarray(coords.transpose(2, 0, 1)[None])))
    model = model.to(device)
    diffusion = build_diffusion(cfg, model)
    lidar_utils = LiDARUtility(
        resolution=tuple(cfg.data.resolution), depth_format=cfg.data.depth_format,
        min_depth=cfg.data.min_depth, max_depth=cfg.data.max_depth,
        ray_angles=coords, data_format="NHWC", device=device,
    )
    print(f"number of parameters: {count_parameters(model) / 1e6:.2f}M")  # cf. reference train.py:111-112

    # ------------------------------------------------- optimizer and resume
    optimizer, scheduler = make_optimizer(model.parameters(), tcfg)
    state = init_train_state(model, optimizer, scheduler)
    start_step = 0
    if tcfg.resume:
        start_step = resume(state, tcfg.resume)
        print(f"resumed from {tcfg.resume} at step {start_step}")
    train_step = make_train_step(
        diffusion, optimizer, scheduler, EMAConfig(beta=tcfg.ema_decay, update_every=tcfg.ema_update_every)
    )
    ema_diffusion = build_diffusion(cfg, state.ema_model)

    # ----------------------------------------------------------------- data
    dataset = make_dataset(cfg.data.dataset, cfg.data.data_root, "train", cfg.data.projection,
                           cache_dir=os.path.join(out_dir, "cache") if cfg.data.data_root else None)
    loader = DataLoader(dataset, batch_size=tcfg.batch_size_train, seed=tcfg.seed)
    keys = (["depth"] if cfg.data.train_depth else []) + (["reflectance"] if cfg.data.train_reflectance else [])
    batches = _device_batches(loader, keys, device)
    logger = MetricLogger(out_dir)

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
              "(repeat the signal to abort)", flush=True)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, on_signal)
        except ValueError:  # not the main thread: no guard
            pass

    def write_checkpoint() -> str:
        return save_checkpoint(os.path.join(out_dir, CHECKPOINT), config_lib.asdict(cfg), state)

    profiler = None
    t0 = time.time()
    global_step = start_step
    try:
        while global_step < tcfg.num_steps and preempted["signal"] is None:
            batch = next(batches)
            if tcfg.profile_dir and global_step - start_step == 10:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            x_0 = preprocess_batch(
                lidar_utils, batch, tuple(cfg.data.resolution), cfg.data.train_depth, cfg.data.train_reflectance
            )
            metrics = train_step(state, x_0, step_generator(tcfg.seed, global_step, device))
            global_step += 1
            if profiler is not None and global_step - start_step == 15:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                profiler.stop()
                os.makedirs(tcfg.profile_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(tcfg.profile_dir, "trace.json"))
                profiler = None
                print(f"profile trace written to {tcfg.profile_dir}")

            if global_step % 50 == 0 or global_step == 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["lr"] = scheduler.get_last_lr()[0]
                m["steps_per_sec"] = (global_step - start_step) / (time.time() - t0)
                logger.log(global_step, m)  # cf. reference train.py:273-277

            if global_step % tcfg.steps_save_image == 0:
                g = step_generator(9, global_step, device)
                samples = ema_diffusion.sample(min(tcfg.batch_size_eval, 8), SAMPLE_STEPS, generator=g)
                save_image_panels(out_dir, global_step, samples, lidar_utils, channels)  # cf. train.py:282-289

            if global_step % tcfg.steps_save_model == 0:
                write_checkpoint()

        path = write_checkpoint()
        if preempted["signal"] is not None:
            print(f"preempted at step {global_step} (signal {preempted['signal']}); "
                  f"resume with --training.resume {path}")
        else:
            print(f"done: {global_step} steps in {time.time() - t0:.0f}s -> {out_dir}")
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if profiler is not None:
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
