"""Headline benchmark of the port: 256-step DDPM sampling throughput at
64x1024 on one card.

    python -m r2dm_tpu_torch.bench [--batch 256] [--steps 256] [--trials 4]
    torchrun --nproc_per_node N -m r2dm_tpu_torch.bench [--mesh N] ...   # on N cards
    torchrun --nproc_per_node D*W -m r2dm_tpu_torch.bench --mesh DxW ...   # width axis

Prints one JSON line with img/s and MFU. The protocol of the repo's
``bench.py``: batch 256, 256 DDPM steps, the continuous-time cosine schedule,
config-H EfficientUNet (2x64x1024), a bf16 network with fp32 diffusion
maths, random weights (N(0, 0.05^2) from seed 0; throughput does not depend
on them), through ``DDPM.sample``. One warm-up step at the batch, then
timed chains (CUDA events, a generator an image from the chain's seeds) while the wall-clock
budget ``$R2DM_BENCH_BUDGET_S`` (default 900 s) covers another, at most
``--trials``; the value is their median, and the line keeps every trial's
seconds. Two secondary measurements follow, as in the repo's
``bench.py:364-420``, each if the budget allows (else ``*_skipped`` with the
reason): ``flow_euler1_*``, one-step rectified-flow (euler) chains on the
same network under a ``timestep_type = "flow"`` diffusion (2 trials of
``FLOW_REPS`` chains, after one untimed call whose samples must be finite
and not constant), then ``ddim32_*``, 32-step DDIM chains. The first
chain's samples must be finite and not constant.

Under ``torchrun`` every data group runs the protocol on its own cards, and
rank 0 prints one line with the aggregate img/s (the data groups' sum)
beside each rank's: the counterpart of the JAX ``bench.py --mesh``, which
shards the batch over the data axis and reports aggregate img/s
(bench.py:191-207). ``--mesh`` ('N' or 'DxW') must multiply to the world
size; with W > 1 the W ranks of a group run the same chains, each on its
columns of the images (``DDPM.sample(world=)``), the latency lane, and the
line's unit is then "img/s aggregate (N dev)", as the JAX line names it
(bench.py:304). MFU counts each card's share of the FLOPs.

``$R2DM_TPU_INT8`` (any non-empty value) runs the network on the int8
serving lane (``models/layers.py::set_quant_conv``, the s8 ring-conv
kernel), as the JAX ``bench.py:149-155`` does; the line then says
``"int8": "w8a8"``, and MFU stays against the bf16 peak, so the two lanes'
numbers compare.

MFU is achieved FLOP/s over the H100 SXM's dense bf16 tensor rate (989
TFLOP/s), with the FLOP count of a config-H forward computed from the
port's module shapes (``forward_flops``): its convolutions (3x3, 1x1 and the
FIR resampling) are 229.0 GFLOP an image, the count of ``bench.py:50-52``
(229.4, XLA's cost analysis); ``mfu_all`` adds the bottleneck attention
and the dense layers (234.9 GFLOP).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import torch

from . import config as config_lib
from . import parallel
from .inference import DDPM, build_diffusion, build_model, model_coords
from .models.efficient_unet import EfficientUNet
from .models.layers import RingConv, set_quant_conv
from .ops import build

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
BATCH = 256
STEPS = 256
MAX_TRIALS = 4
DDIM_STEPS = 32
FLOW_REPS = 8  # one-step flow chains a timed trial
FLOW_NET_CALLS = 1 + 2 * FLOW_REPS  # the untimed call, then 2 trials
FIR_TAPS = 16  # the 4x4 FIR filter of the 2x resampling, one channel at a time


def forward_flops(model: EfficientUNet) -> dict[str, int]:
    """FLOPs of one forward of one image, by kind, from the module shapes:
    ``conv`` (every 3x3 and 1x1 conv at its level's resolution),
    ``resample`` (the depthwise FIR filters of the 2x down/upsampling),
    ``attention`` (the packed projections and the two batched products of
    each self-attention block) and ``dense`` (time embedding, AdaGN
    projections). A multiply-add counts 2."""

    def conv(m: RingConv, h: int, w: int) -> int:
        return 2 * h * w * m.weight.numel()

    h, w = model.resolution
    flops = {"conv": conv(model.in_conv, h, w) + conv(model.out_conv, h, w), "resample": 0, "attention": 0,
             "dense": sum(2 * m.weight.numel() for m in model.time_embedding if isinstance(m, torch.nn.Linear))}
    for name in ("d_block1", "d_block2", "d_block3", "d_block4", "u_block4", "u_block3", "u_block2", "u_block1"):
        blk = getattr(model, name)
        if blk.downsample is not None:
            down_conv = blk.downsample[0]
            flops["conv"] += conv(down_conv, h, w)
            h, w = h // 2, w // 2
            flops["resample"] += 2 * h * w * down_conv.weight.shape[0] * FIR_TAPS
        for rb in blk.residual_blocks:
            flops["conv"] += conv(rb.conv1, h, w) + conv(rb.conv2, h, w)
            if rb.skip is not None:
                flops["conv"] += conv(rb.skip, h, w)
            flops["dense"] += 2 * rb.norm2.proj[1].weight.numel()
        if blk.self_attn_block is not None:
            attn = blk.self_attn_block.attn
            n, c = h * w, attn.out_proj.weight.shape[0]
            flops["attention"] += 2 * n * attn.in_proj_weight.numel() + 2 * 2 * n * n * c + 2 * n * c * c
        if blk.upsample is not None:
            up_conv = blk.upsample[1]
            h, w = h * 2, w * 2
            flops["resample"] += 2 * h * w * up_conv.weight.shape[0] * FIR_TAPS
            flops["conv"] += conv(up_conv, h, w)
    return flops


def protocol_flops(flops: dict[str, int]) -> int:
    """The count MFU uses: the convolutions, as the repo's bench.py counts."""
    return flops["conv"] + flops["resample"]


def int8_lane():
    """The serving lane ``$R2DM_TPU_INT8`` asks for: "w8a8", or None."""
    return "w8a8" if os.environ.get("R2DM_TPU_INT8") else None


def random_ddpm(device="cuda", seed: int = 0, cfg=None) -> DDPM:
    """Config H (or ``cfg``) with every parameter N(0, 0.05^2) from ``seed``
    (so the zero-initialised output conv is not zero), bf16 on CUDA, on the
    int8 lane under ``$R2DM_TPU_INT8``."""
    cfg = cfg or config_lib.Config()
    bf16 = torch.device(device).type == "cuda"
    model = build_model(cfg, dtype=torch.bfloat16 if bf16 else None, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        model.coords.copy_(torch.from_numpy(model_coords(cfg).transpose(2, 0, 1)[None].copy()))
    model = set_quant_conv(model.to(device), int8_lane())
    return DDPM(build_diffusion(cfg, model), cfg)


def card() -> str:
    """``name, power limit`` of the card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def chain(ddpm: DDPM, batch: int, steps: int, mode: str, seed: int, world=None) -> torch.Tensor:
    """One chain of the protocol through DDPM.sample, NHWC: image i of it
    drawn from seed ``seed * batch + i``, so that every rank of a group can
    run it (a process group refuses DDPM's internal stream) and the width
    ranks of a data group draw alike."""
    return ddpm.sample(batch, steps, mode=mode, data_format="NHWC", world=world,
                       seeds=list(range(seed * batch, (seed + 1) * batch)))


def _timed(ddpm: DDPM, batch: int, steps: int, mode: str, seed: int, world=None):
    """One ``chain``, device time from CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    x = chain(ddpm, batch, steps, mode, seed, world)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3, x


def aggregate(results: list[dict], width_size: int = 1) -> dict:
    """One line from every rank's result (rank order, ``width_size`` ranks a
    data group): rank 0's, with ``value``, ``flow_euler1_img_per_s`` and
    ``ddim*_img_per_s`` the data groups' sums (each group's images counted
    once, from its width rank 0), MFU against the ranks' summed peak, and
    each rank's img/s beside them. One rank's result is returned as it
    is."""
    if len(results) == 1:
        return results[0]
    groups = results[::width_size]
    out = dict(results[0])
    out["ranks"] = len(results)
    out["per_rank_img_per_s"] = [r["value"] for r in results]
    out["value"] = sum(r["value"] for r in groups)
    for key in ("mfu", "mfu_all"):
        out[key] = sum(r[key] for r in results) / len(results)
    for key in [k for k in out if k.startswith(("ddim", "flow")) and k.endswith("_img_per_s")]:
        per_rank = [r.get(key) for r in results]
        out[f"per_rank_{key}"] = per_rank
        out[key] = sum(per_rank[::width_size]) if None not in per_rank else None
    return out


def main(batch: int = BATCH, steps: int = STEPS, trials: int = MAX_TRIALS, ddim_steps: int = DDIM_STEPS,
         mesh: str = "") -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("r2dm_tpu_torch.bench: no CUDA device; the benchmark runs on an NVIDIA card")
    world = parallel.init("cuda", mesh=mesh)
    try:
        result = aggregate(parallel.all_gather_objects(world, _protocol(batch, steps, trials, ddim_steps, world)),
                           world.width_size)
        if mesh:
            result["unit"] = f"img/s aggregate ({world.size} dev)"
    finally:
        world.close()
    if world.is_main:
        print(json.dumps(result), flush=True)
    return result


def _protocol(batch: int, steps: int, trials: int, ddim_steps: int, world=None) -> dict:
    budget_s = float(os.environ.get("R2DM_BENCH_BUDGET_S", "900"))
    t_start = time.time()
    build.build_all()
    ddpm = random_ddpm("cuda")
    if int8_lane():
        print("R2DM_TPU_INT8: the network runs the int8 (W8A8) lane; MFU against the bf16 peak", flush=True)
    flops = forward_flops(ddpm.model)
    h, w = ddpm.sampling_shape[:2]

    torch.cuda.reset_peak_memory_stats()
    _timed(ddpm, batch, 1, "ddpm", 0, world)  # warm-up: one step at the batch
    warm_s, _ = _timed(ddpm, batch, 1, "ddpm", 0, world)
    est_trial = warm_s * steps
    times = []
    for trial in range(trials):
        remaining = budget_s - (time.time() - t_start)
        if times and remaining < est_trial * 1.15:
            break
        dt, x = _timed(ddpm, batch, steps, "ddpm", trial + 1, world)
        if not times:
            xs = x[:2].float()
            if not (bool(torch.isfinite(xs).all()) and xs.std().item() > 0.1):
                raise AssertionError("degenerate samples: non-finite or constant")
        times.append(dt)
        est_trial = dt
        del x

    dt = statistics.median(times)
    img_per_s = batch / dt
    cards = world.width_size if world is not None else 1  # the cards that share each image
    per_image = steps * protocol_flops(flops) / cards
    result = {
        "metric": f"sampling_throughput_{steps}step_{h}x{w}",
        "value": img_per_s,
        "unit": "img/s",
        "mfu": img_per_s * per_image / PEAK_BF16_FLOPS,
        "mfu_all": img_per_s * steps * sum(flops.values()) / cards / PEAK_BF16_FLOPS,
        "gflop_per_forward": protocol_flops(flops) / 1e9,
        "gflop_per_forward_all": sum(flops.values()) / 1e9,
        "batch": batch,
        "steps": steps,
        "seconds_median": dt,
        "seconds_min": min(times),
        "seconds_max": max(times),
        "seconds_stdev": statistics.stdev(times) if len(times) > 1 else 0.0,
        "trials": len(times),
        "seconds_all": times,
        "warmup_step_s": warm_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "int8": int8_lane(),
        "device": torch.cuda.get_device_name(0),
        "card": card(),
    }
    flow_cost = est_trial / steps  # one network call at the batch
    remaining = budget_s - (time.time() - t_start)
    if remaining <= flow_cost * FLOW_NET_CALLS:
        result["flow_euler1_skipped"] = f"budget ({remaining:.0f} s left)"
    else:
        result.update(_flow_euler1(ddpm, batch, world))
    ddim_cost = est_trial * ddim_steps / steps
    remaining = budget_s - (time.time() - t_start)
    if remaining < 2.5 * ddim_cost:
        result[f"ddim{ddim_steps}_skipped"] = f"budget ({remaining:.0f} s left)"
    else:
        dts = [_timed(ddpm, batch, ddim_steps, "ddim", 90 + i, world)[0] for i in range(2)]
        result[f"ddim{ddim_steps}_img_per_s"] = batch / statistics.median(dts)
        result[f"ddim{ddim_steps}_seconds_median"] = statistics.median(dts)
        result[f"ddim{ddim_steps}_trials"] = len(dts)
    return result


def _flow_euler1(ddpm: DDPM, batch: int, world=None) -> dict:
    """The one-step rectified-flow secondary headline: ``ddpm``'s network
    under a flow diffusion built from a default Config, one untimed chain
    (its first two samples finite with std > 0.1), then 2 trials of
    ``FLOW_REPS`` chains each (CUDA events); img/s from the median trial."""
    cfg = config_lib.Config()
    cfg.diffusion.timestep_type = "flow"
    flow = DDPM(build_diffusion(cfg, ddpm.model), cfg)
    x = _timed(flow, batch, 1, "euler", 70, world)[1][:2].float()
    if not (bool(torch.isfinite(x).all()) and x.std().item() > 0.1):
        raise AssertionError("flow euler-1: non-finite or constant samples")
    del x
    trials = []
    for trial in range(2):
        seconds = [_timed(flow, batch, 1, "euler", 71 + trial * FLOW_REPS + r, world)[0] for r in range(FLOW_REPS)]
        trials.append(sum(seconds) / FLOW_REPS)
    dt = statistics.median(trials)
    return {"flow_euler1_img_per_s": batch / dt, "flow_euler1_seconds_median": dt, "flow_euler1_trials": len(trials)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=BATCH, help="images per chain (protocol: 256)")
    parser.add_argument("--steps", type=int, default=STEPS, help="DDPM steps (protocol: 256)")
    parser.add_argument("--trials", type=int, default=MAX_TRIALS, help="most timed chains")
    parser.add_argument("--ddim_steps", type=int, default=DDIM_STEPS, help="steps of the DDIM measurement")
    parser.add_argument("--mesh", type=str, default="", help="'N' or 'DxW': must multiply to the torchrun world size")
    a = parser.parse_args()
    main(a.batch, a.steps, a.trials, a.ddim_steps, a.mesh)
