#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (r2dm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure makes the exit code non-zero and suppresses the result):
  1. print the card's name and power limit; build both CUDA kernels from
     r2dm_tpu_torch/csrc with nvcc (one process per source, in parallel);
     print each library's HGMMA count (cuobjdump -sass) and each kernel's
     registers, spill bytes and shared memory (ptxas), and the GroupNorm
     kernel's cluster size with cudaOccupancyMaxActiveClusters;
  2. kernel 1 (gn_silu.cu) against its plain version at the config-H shapes,
     and its SiLU over z in [-10, 10] to one bf16 step;
  3. kernel 2 (act_ringconv.cu) against its plain version at every
     (C_in, F, H, W) of the config-H ResidualBlocks, with and without its
     SiLU prologue (the main path runs it without);
  4. the main path at full width: random config-H weights saved as a
     reference-layout .pth, loaded by setup_model in bf16 on the card, a
     16-step DDIM and a 4-step DDPM chain at batch 8 with per-sample seeds,
     then LiDARUtility denormalize -> revert_depth -> to_xyz. The launch
     counters are zeroed just before and read just after; one network
     forward is compared between the kernel path and the plain path;
  5. time each kernel, its plain version and the one PyTorch call that
     computes the same function (library_ms, a yardstick the port never
     calls), beside the least time the card could take (bound_ms);
  6. one batch-8 network forward: its time as the host drives it, its
     device time and each part's (CUDA graphs), the host's time to enqueue
     it, and the operations that block the host (sync debug mode).
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, without a
CUDA device or without the port's package.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

B = 8  # batch of every check and of the main path
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

# config H, batch 8: (C, H, W) of every GroupNorm input. 64x1024x128 is the
# u_block1 concat input; 8x128x512 / 8x128x256 are also the attention norms.
GN_SHAPES = [(64, 64, 1024), (128, 64, 1024), (128, 32, 512), (256, 32, 512),
             (64, 32, 512), (256, 16, 256), (512, 16, 256), (128, 16, 256),
             (512, 8, 128), (256, 8, 128)]
# every (C_in, F, H, W) of a config-H ResidualBlock conv, with its count per
# network forward (conv1 and conv2 of 24 blocks = 48 launches)
CONV_SHAPES = {
    (64, 64, 64, 1024): 6 + 5,   # d_block1; u_block1 past its first conv
    (128, 64, 64, 1024): 1,      # u_block1 block 0 conv1 (concat input)
    (128, 128, 32, 512): 6,      # d_block2 (its down conv sets 128 channels)
    (256, 64, 32, 512): 1,       # u_block2 block 0 conv1 (concat input)
    (64, 64, 32, 512): 5,        # u_block2
    (256, 256, 16, 256): 6,      # d_block3
    (512, 128, 16, 256): 1,      # u_block3 block 0 conv1 (concat input)
    (128, 128, 16, 256): 5,      # u_block3
    (512, 512, 8, 128): 6,       # d_block4
    (512, 256, 8, 128): 1,       # u_block4 block 0 conv1
    (256, 256, 8, 128): 5,       # u_block4
}
SOURCES = {
    "fused_group_norm_silu": ("r2dm_tpu_torch/csrc/gn_silu.cu", "r2dm_tpu/ops/pallas_gn.py:107"),
    "fused_act_ringconv": ("r2dm_tpu_torch/csrc/act_ringconv.cu", "r2dm_tpu/ops/pallas_resconv.py:174"),
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured into one
    CUDA graph and replayed, so the host's per-call cost (the wrappers'
    checks and allocations, Python) does not bound the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture requires
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def randn(torch, shape, seed, dtype=None, scale=1.0, offset=0.0):
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") * scale + offset
    return x.to(dtype) if dtype is not None else x


class Phases:
    def __init__(self):
        self.failed: list[str] = []

    def run(self, name: str, fn, *args):
        log(f"--- {name}")
        t0 = time.time()
        try:
            out = fn(*args)
        except Exception as e:  # a phase that fails must not stop the report
            import traceback

            traceback.print_exc()
            self.failed.append(f"{name}: {type(e).__name__}: {e}")
            return None
        log(f"--- {name}: ok in {time.time() - t0:.1f} s")
        return out


def ptxas_kernels(log_text: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel, from
    nvcc's -Xptxas -v output."""
    kernels, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = {"registers": None, "spill_bytes": 0, "smem_bytes": 0}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                kernels[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                kernels[name]["registers"] = int(m.group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                kernels[name]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return kernels


def phase_build():
    from r2dm_tpu_torch.ops import build

    t0 = time.time()
    build.build_all()
    seconds = time.time() - t0
    print(f"kernels built in {seconds:.1f} s (nvcc, sm_90a, one process per source)")
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    for name in build.SOURCES:
        lib = str(build._target(name))
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, timeout=120)
        if sass.returncode != 0:
            raise RuntimeError(f"cuobjdump -sass {lib}: {sass.stderr.strip()}")
        info = {"hgmma": sum("HGMMA" in line for line in sass.stdout.splitlines()),
                "kernels": ptxas_kernels(build.build_log(name))}
        print(f"build {name}: {json.dumps(info)}")
        if name == "act_ringconv" and info["hgmma"] == 0:
            raise RuntimeError("the ring-conv library has no HGMMA instruction: wgmma was not compiled")
        for line in build.build_log(name).splitlines():
            if "warning" in line.lower() or "wgmma" in line.lower():
                log(f"[{name}] {line.strip()}")
    # the GroupNorm kernel runs one cluster of K CTAs per sample; b8 needs
    # 8 clusters at once
    from r2dm_tpu_torch.ops import gn_silu

    fit = {C: gn_silu.max_active_clusters(C) for C in (64, 128, 256, 512)}
    print(f"build gn_silu clusters: {json.dumps({'cluster_ctas': gn_silu.CLUSTER, 'max_active_clusters': fit})}")
    if min(fit.values()) < B:
        raise RuntimeError(f"fewer than {B} GroupNorm clusters fit the card at once: {fit}")
    return seconds


def phase_gn(torch):
    from r2dm_tpu_torch.ops import gn_silu

    G, eps = 8, 1e-6
    worst = {"fused_group_norm_silu": 0.0}
    for C, H, W in GN_SHAPES:
        x = randn(torch, (B, H, W, C), 1, torch.bfloat16, offset=0.1)
        for per_batch in (False, True):
            aff = (B, C) if per_batch else (C,)
            gain = randn(torch, aff, 2, scale=0.5, offset=1.0)
            shift = randn(torch, aff, 3, scale=0.5)
            for silu in (True, False):
                y = gn_silu.fused_group_norm_silu(x, gain, shift, G, eps, apply_silu=silu)
                ref = gn_silu.fused_group_norm_silu_plain(x, gain, shift, G, eps, apply_silu=silu)
                err = (y.float() - ref.float()).abs()
                # bf16 output: rtol = atol = 2e-2 (tests/test_pallas_gn.py)
                if not bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all()):
                    raise AssertionError(f"gn_silu {(C, H, W)} silu={silu}: max|err| {err.max().item():.3e}")
                worst["fused_group_norm_silu"] = max(worst["fused_group_norm_silu"], err.max().item())
        print(f"gn_silu ok at (B, H, W, C) = {(B, H, W, C)}")
    # the SiLU in both tails: normalised values evenly over [-sqrt(3),
    # sqrt(3)] in every channel (group mean 0, shift 0), z = x*a + b over
    # [-10, 10]; kernel and plain version each round fp32 to bf16 once, so
    # they may differ by one bf16 step (2^-7 of the value) and no more
    C, H, W = 64, 8, 128
    grid = torch.linspace(-1.0, 1.0, H * W, device="cuda").to(torch.bfloat16)
    x = torch.stack([grid.roll(37 * c) for c in range(C)], dim=-1).reshape(1, H, W, C).expand(B, H, W, C).contiguous()
    gain, shift = torch.full((C,), 10.0 / 3.0 ** 0.5, device="cuda"), torch.zeros(C, device="cuda")
    y = gn_silu.fused_group_norm_silu(x, gain, shift, G, eps).float()
    ref = gn_silu.fused_group_norm_silu_plain(x, gain, shift, G, eps).float()
    rel = ((y - ref).abs() / ref.abs()).max().item()
    print(f"gn_silu SiLU over z in [-10, 10]: max relative error {rel:.3e} (limit 2^-7)")
    if not rel <= 2.0 ** -7:
        raise AssertionError(f"gn_silu SiLU tail: max relative error {rel:.3e}")
    torch.cuda.synchronize()
    return worst


def phase_conv(torch):
    from r2dm_tpu_torch.ops import act_ringconv

    # the plain reference runs cuDNN in bf16; TF32 is off for any fp32 path
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = 0.0
    for (C, Fo, H, W) in CONV_SHAPES:
        x = randn(torch, (B, H, W, C), 4, torch.bfloat16)
        a = randn(torch, (B, C), 5, scale=0.5, offset=1.0)
        b = randn(torch, (B, C), 6, scale=0.2)
        k = randn(torch, (3, 3, C, Fo), 7, scale=(9 * C) ** -0.5)
        bias = randn(torch, (Fo,), 8, scale=0.1)
        for act in (True, False):
            y = act_ringconv.fused_act_ringconv(x, a, b, k, bias, apply_act=act)
            ref = act_ringconv.act_ringconv_plain(x, a, b, k, bias, apply_act=act)
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            # bf16: max|err| <= 1e-2 * max|ref|
            if not err <= 1e-2 * scale:
                raise AssertionError(f"act_ringconv {(C, Fo, H, W)} act={act}: max|err| {err:.3e} vs max|ref| {scale:.3e}")
            worst = max(worst, err)
        print(f"act_ringconv ok at (B, H, W, C_in, F) = {(B, H, W, C, Fo)}")
    torch.cuda.synchronize()
    return worst


def phase_main(torch):
    from r2dm_tpu_torch import config as config_lib
    from r2dm_tpu_torch import ops, setup_model
    from r2dm_tpu_torch.inference import build_model, model_coords
    from r2dm_tpu_torch.models import layers

    cfg = config_lib.Config()  # config H
    net = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    sd = {}
    for k, v in net.state_dict().items():
        if k == "coords":
            sd[k] = torch.from_numpy(model_coords(cfg).transpose(2, 0, 1)[None].copy())
        else:  # every parameter ~ N(0, 0.05^2), so out_conv is non-zero
            sd[k] = torch.randn(v.shape, generator=g) * 0.05
    del net
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "r2dm-h-random.pth")
        torch.save({
            "cfg": config_lib.asdict(cfg),
            "weights": {f"model.{k}": v for k, v in sd.items()},
            "ema_weights": {
                **{f"ema_model.model.{k}": v for k, v in sd.items()},
                "initted": torch.tensor(True), "step": torch.tensor(1),
            },
            "global_step": 1,
        }, path)
        ddpm, lidar, cfg = setup_model(path, dtype=torch.bfloat16, device="cuda")
    print(f"config H on the card: {ddpm.num_parameters} parameters, bf16 compute")

    ddpm.sample(batch_size=B, num_steps=1, mode="ddim", seeds=range(B))  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.time()
    x = ddpm.sample(batch_size=B, num_steps=16, mode="ddim", seeds=range(B))
    torch.cuda.synchronize()
    ddim_s = time.time() - t0
    x2 = ddpm.sample(batch_size=B, num_steps=4, mode="ddpm", seeds=range(B, 2 * B))
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    forwards = 16 + 4
    # per forward: 48 ResidualBlock norms and 2 attention norms through the
    # whole function, 48 convs without their prologue
    expected = {"fused_group_norm_silu": 50 * forwards, "fused_act_ringconv": 48 * forwards}
    print(f"main path launches {json.dumps(launches)} (expected {json.dumps(expected)})")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    ddim_runs = [ddim_s]  # two more timed runs (host clock); the median is reported
    for _ in range(2):
        t0 = time.time()
        ddpm.sample(batch_size=B, num_steps=16, mode="ddim", seeds=range(B))
        torch.cuda.synchronize()
        ddim_runs.append(time.time() - t0)
    ddim_s = sorted(ddim_runs)[1]

    for name, s in (("ddim16", x), ("ddpm4", x2)):
        if tuple(s.shape) != (B, 2, 64, 1024) or not bool(torch.isfinite(s).all()):
            raise AssertionError(f"{name}: shape {tuple(s.shape)} or non-finite values")
        # the final step adds sigma_0 (5.5e-4) times noise/eps to the
        # clipped x_0, so |x| may pass 1 by that much
        peak = s.abs().max().item()
        if peak > 1.02:
            raise AssertionError(f"{name}: max|x| {peak} outside [-1, 1]")
        depth = lidar.revert_depth(lidar.denormalize(s[:, [0]]))
        xyz = lidar.to_xyz(depth)
        if tuple(xyz.shape) != (B, 3, 64, 1024) or not bool(torch.isfinite(xyz).all()):
            raise AssertionError(f"{name}: bad xyz {tuple(xyz.shape)}")
        valid = lidar.get_mask(depth).mean().item()
        print(f"{name}: max|x| {peak:.4f}, std {s.std().item():.4f}, valid points {valid:.3f}")

    # one network forward: kernel path against the plain path, on the card
    xin = randn(torch, (2, 64, 1024, 2), 9)
    cond = torch.tensor([2.0, -3.0], device="cuda")
    with torch.inference_mode():
        y_kernel = ddpm.model(xin, cond)
        patched = {"fused_group_norm_silu": ops.gn_silu.fused_group_norm_silu_plain,
                   "fused_act_ringconv": ops.act_ringconv.act_ringconv_plain}
        saved = {n: getattr(layers, n) for n in patched}
        try:
            for n, fn in patched.items():
                setattr(layers, n, fn)
            y_plain = ddpm.model(xin, cond)
        finally:
            for n, fn in saved.items():
                setattr(layers, n, fn)
    rel = ((y_kernel - y_plain).norm() / y_plain.norm()).item()
    print(f"network forward, kernel path vs plain path: relative L2 {rel:.3e} (limit 2e-2)")
    if not (rel <= 2e-2 and math.isfinite(rel)):
        raise AssertionError(f"kernel path vs plain path relative L2 {rel}")
    img_s = B / ddim_s
    print(f"ddim16 b{B}: runs {json.dumps(ddim_runs)} s, median {ddim_s:.4f} s, {img_s:.4f} img/s")
    return {"launches": launches, "ddim16_img_s": img_s, "ddim16_s": ddim_s, "rel_l2": rel, "ddpm": ddpm}


def phase_breakdown(torch, ddpm):
    """Where one batch-B network forward spends its time: the forward as
    the host drives it, its device time, and each part's device time on the
    inputs it receives in a real forward (captured with forward hooks)."""
    from r2dm_tpu_torch.models.layers import ResidualBlock

    net = ddpm.model
    parts = {"in_conv": net.in_conv, "out_conv": net.out_conv, "time_embedding": net.time_embedding}
    for name in ("d_block1", "d_block2", "d_block3", "d_block4", "u_block4", "u_block3", "u_block2", "u_block1"):
        blk = getattr(net, name)
        if blk.downsample is not None:
            parts[f"{name}.down_conv"], parts[f"{name}.fir_down"] = blk.downsample[0], blk.downsample[1]
        if blk.upsample is not None:
            parts[f"{name}.fir_up"], parts[f"{name}.up_conv"] = blk.upsample[0], blk.upsample[1]
        if blk.self_attn_block is not None:
            parts[f"{name}.attention"] = blk.self_attn_block
        for i, rb in enumerate(blk.residual_blocks):
            parts[f"{name}.res{i}"] = rb
    captured = {}

    def keep_inputs(name):
        def hook(module, args, output):
            captured.setdefault(name, args)
        return hook

    hooks = [m.register_forward_hook(keep_inputs(n)) for n, m in parts.items()]
    xin = randn(torch, (B, 64, 1024, 2), 10)
    cond = torch.linspace(-5.0, 5.0, B, device="cuda")
    try:
        with torch.inference_mode():
            net(xin, cond)
    finally:
        for h in hooks:
            h.remove()
    with torch.inference_mode():
        forward_ms = cuda_ms(torch, lambda: net(xin, cond), iters=5, warmup=2)
        # host time to enqueue one forward: below forward_ms, the host keeps
        # the card fed at this batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net(xin, cond)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        # operations that block the host until the card drains its queue,
        # in two forwards one after the other and in one 2-step sampling call
        syncs = {}
        for what, fn in (("forward", lambda: net(xin, cond)),
                         ("forward_again", lambda: net(xin, cond)),
                         ("sample_2_steps", lambda: ddpm.sample(B, 2, seeds=range(B)))):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    fn()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs[what] = ["/".join(w.filename.split(os.sep)[-3:]) + f":{w.lineno}"
                           for w in caught if "synchroniz" in str(w.message)]
        torch.cuda.synchronize()
        # device time alone (CUDA graphs): of the forward, and of each part
        device_ms = graph_ms(torch, lambda: net(xin, cond), iters=3)
        times = {n: graph_ms(torch, lambda m=parts[n], a=captured[n]: m(*a), iters=3) for n in parts}
    groups = {"residual blocks": [n for n, m in parts.items() if isinstance(m, ResidualBlock)]}
    for key in ("fir_down", "fir_up", "down_conv", "up_conv", "attention"):
        groups[key] = [n for n in parts if n.endswith(key)]
    groups["in/out conv, time embedding"] = ["in_conv", "out_conv", "time_embedding"]
    summary = {g: sum(times[n] for n in names) for g, names in groups.items()}
    summary["rest (concat, casts, encoding)"] = device_ms - sum(summary.values())
    print(f"forward breakdown b{B}: " + json.dumps({
        "forward_ms": forward_ms, "device_ms": device_ms, "device_idle_share": 1.0 - device_ms / forward_ms,
        "host_enqueue_ms": enqueue_ms, "host_syncs": syncs, "device_ms_by_part": summary,
    }))


def phase_time(torch, launches, errs):
    import torch.nn.functional as F

    from r2dm_tpu_torch.ops import act_ringconv, gn_silu
    from r2dm_tpu_torch.ops.pad import ring_pad

    G, eps = 8, 1e-6
    rows = []

    def row(name, route, ms, plain_ms, bound_bytes, bound_ops, peak, library_ms, shape, err):
        t_bytes = bound_bytes / PEAK_BYTES * 1e3
        t_ops = bound_ops / peak * 1e3
        src, replaces = SOURCES[name]
        rows.append({
            "name": name, "route": route, "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": shape,
        })

    # kernel 1: the d_block4 attention norm input
    C, H, W = 512, 8, 128
    x = randn(torch, (B, H, W, C), 14, torch.bfloat16)
    gain, shift = randn(torch, (C,), 15), randn(torch, (C,), 16)
    ms = graph_ms(torch, lambda: gn_silu.fused_group_norm_silu(x, gain, shift, G, eps, apply_silu=True))
    plain = graph_ms(torch, lambda: gn_silu.fused_group_norm_silu_plain(x, gain, shift, G, eps, apply_silu=True))
    xc = x.permute(0, 3, 1, 2)
    lib = graph_ms(torch, lambda: F.silu(F.group_norm(xc, G, gain.to(x.dtype), shift.to(x.dtype), eps)))
    row("fused_group_norm_silu", "cuda", ms, plain, 2 * x.numel() * 2, 10 * x.numel(), PEAK_FP32_FLOPS,
        lib, [B, H, W, C], errs["fused_group_norm_silu"])

    # kernel 2: every config-H shape, as the main path calls it (the input
    # already activated, apply_act=False; act_ms: with the SiLU prologue);
    # the JSON row is level 1, 64 -> 64
    per_shape = []
    for (C, Fo, H, W), count in CONV_SHAPES.items():
        x = randn(torch, (B, H, W, C), 17, torch.bfloat16)
        a, b = randn(torch, (B, C), 18, offset=1.0), randn(torch, (B, C), 19)
        k = randn(torch, (3, 3, C, Fo), 20, scale=0.05)
        bias = randn(torch, (Fo,), 21)
        ms = graph_ms(torch, lambda: act_ringconv.fused_act_ringconv(x, None, None, k, bias, apply_act=False))
        act_ms = graph_ms(torch, lambda: act_ringconv.fused_act_ringconv(x, a, b, k, bias))
        plain = graph_ms(torch, lambda: act_ringconv.act_ringconv_plain(x, None, None, k, bias, apply_act=False))
        xp = ring_pad(x, 1).permute(0, 3, 1, 2)
        wt = k.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bb = bias.to(torch.bfloat16)
        lib = graph_ms(torch, lambda: F.conv2d(xp, wt, bb))
        flops = 2 * 9 * C * Fo * B * H * W
        nbytes = (B * H * W * (C + Fo)) * 2 + 9 * C * Fo * 2 + Fo * 4
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        # the norm before this conv sees the same input: GN + SiLU, and GN
        # alone (the SiLU's cost); bound: x read once, y written once
        gn_silu_ms = graph_ms(torch, lambda: gn_silu.fused_group_norm_silu(x, a[0], b[0], G, eps))
        gn_nosilu_ms = graph_ms(torch, lambda: gn_silu.fused_group_norm_silu(x, a[0], b[0], G, eps, apply_silu=False))
        gn_silu_bound = max(2 * x.numel() * 2 / PEAK_BYTES, 10 * x.numel() / PEAK_FP32_FLOPS) * 1e3
        per_shape.append({"cin": C, "f": Fo, "h": H, "w": W, "per_forward": count, "ms": ms,
                          "act_ms": act_ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                          "tflops": flops / ms / 1e9, "gn_silu_ms": gn_silu_ms, "gn_nosilu_ms": gn_nosilu_ms,
                          "gn_silu_bound_ms": gn_silu_bound})
        if (C, Fo, H, W) == (64, 64, 64, 1024):
            row("fused_act_ringconv", "cuda", ms, plain, nbytes, flops, PEAK_BF16_FLOPS, lib,
                [B, H, W, C, Fo], errs["fused_act_ringconv"])
    total = {k: sum(s[k] * s["per_forward"] for s in per_shape)
             for k in ("ms", "act_ms", "plain_ms", "library_ms", "bound_ms", "gn_silu_ms", "gn_nosilu_ms",
                       "gn_silu_bound_ms")}
    print("ResidualBlock kernels per shape: " + json.dumps({"shapes": per_shape, "per_forward_total": total}))
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        log("chip_smoke: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on an NVIDIA card")
        return 2
    try:
        import r2dm_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: the r2dm_tpu_torch package is missing ({e}); run from the repo root")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.manual_seed(0)

    phases = Phases()
    if phases.run("build", phase_build) is None:
        for line in phases.failed:
            log(f"FAILED {line}")
        return 1
    gn_err = phases.run("kernel 1 against its plain version", phase_gn, torch)
    conv_err = phases.run("kernel 2 against its plain version", phase_conv, torch)
    main_out = phases.run("main path", phase_main, torch)
    if main_out is not None and gn_err is not None and conv_err is not None:
        errs = {**gn_err, "fused_act_ringconv": conv_err}
        rows = phases.run("timing", phase_time, torch, main_out["launches"], errs)
        phases.run("breakdown", phase_breakdown, torch, main_out["ddpm"])
    else:
        rows = None
    if phases.failed:
        for line in phases.failed:
            log(f"FAILED {line}")
        return 1
    print(f"ddim16_b{B}_img_per_s {main_out['ddim16_img_s']:.4f}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
