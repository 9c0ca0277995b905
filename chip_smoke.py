#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (r2dm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure makes the exit code non-zero and suppresses the result):
  1. print the card's name and power limit; build the CUDA kernels from
     r2dm_tpu_torch/csrc with nvcc (one process per source, in parallel);
     print each library's HGMMA and IGMMA counts (cuobjdump -sass) and each
     kernel's registers, spill bytes and shared memory (ptxas), and the
     GroupNorm kernel's cluster size with cudaOccupancyMaxActiveClusters;
  2. kernel 1 (gn_silu.cu) against its plain version at the config-H shapes,
     and its SiLU over z in [-10, 10] to one bf16 step;
  3. kernel 2 (act_ringconv.cu) against its plain version at every
     (C_in, F, H, W) of the config-H ResidualBlocks, with and without its
     SiLU prologue (the main path runs it without), in the tile variant
     ops/act_ringconv.py::tile_variant picks; then the down convs
     composed with their FIR filter (ops/fused_resample.py: cuDNN, one
     sample a call; the JAX package's default down path) against the
     two-op form at every config-H down shape, bf16 and fp32, and the
     composed up path at the up shapes,
     each form timed; and the W2C record: a cuDNN 3x2 conv on the
     width-merged level-1 tensor against the port's ring-conv kernel on the
     NHWC one, at b1 and b8;
  4. the main path at full width: random config-H weights saved as a
     reference-layout .pth, loaded by setup_model in bf16 on the card, a
     16-step DDIM and a 4-step DDPM chain at batch 8 with per-sample seeds,
     then LiDARUtility denormalize -> revert_depth -> to_xyz. Its forwards
     replay a CUDA graph (models/forward_graph.py), which launches the
     kernels with no wrapper call, so its launches are the kernels that ran
     on the card, read from a torch.profiler record (``device_launches``);
     so are those of one b8 and one b256 forward's ring convs by tile
     variant, against the rule's split (the b256 forward, eager, also
     counts its composed down convs: 3); one network forward is compared
     between the kernel path and the plain path at every batch at which
     this script runs the network (2, 4, 8, 32);
  5. every other serving path at full width from that checkpoint, each with
     its seconds (the profiler on) and exact launches on the card: dpmpp_2m, flow euler and
     midpoint, discrete ddpm and ddim, return_all, RePaint at b4 over the
     four masks of completion_demo.py (known pixels kept to 1e-2),
     ``python -m r2dm_tpu_torch.generate`` (b2, 4 DDIM steps), again with
     ``--latency_layout`` (the same PNGs byte for byte), and
     ``r2dm_tpu_torch.bench`` (b8, 4 steps, 1 trial, its flow euler-1 line
     finite); the .pth exporter's round trip (msgpack -> ``python -m
     r2dm_tpu_torch.export_torch_ckpt`` -> setup_model, the same forward);
     then the peak memory per image of one sampling step and one RePaint
     step (from b32 and b64, eager) against DDPM.MAX_BATCH_PIXELS;
  6. time each kernel, its plain version and the one PyTorch call that
     computes the same function (library_ms, a yardstick the port never
     calls), beside the least time the card could take (bound_ms); the
     ring conv at every ResidualBlock shape at b8 (and its dx shape), and
     the 48 shapes of a forward summed at b8 and at b256 (each b256 shape
     checked against its plain version, at phase 3's limit);
  7. one batch-8 network forward: its time as the host drives it, its
     device time and each part's (CUDA graphs), the host's time to enqueue
     it replayed and eager, and the operations that block the host (sync debug mode); the
     three down paths composed against two ops on their real inputs, and
     the forward's device time both ways (relative L2 <= 2e-2);
  8. training: each kernel's backward against autograd of its plain version
     at every config-H shape (GN: dx, d_gain, d_shift with (C,) and (B, C)
     gains; the conv: dx through the kernel, dW, d_bias); one config-H b8
     loss + backward through the kernel path against the plain path (relative
     L2 of the loss and of the flattened gradient); ``python -m
     r2dm_tpu_torch.train`` on the synthetic set at config H, b8, for 10
     steps and resumed for 2 more, with exact launch counts (50 GN + 96 conv
     a step; 3 composed down convs a step, under autograd), a finite loss, and the step and AdamW state continuing; then
     the median train-step time (CUDA events), its peak memory and the
     host's enqueue time against the device time, and the GN backward, the
     conv's dx (the kernel at the transposed shapes) and dW at every
     ResidualBlock shape;
  9. evaluation: random extractor weights written in their published
     layouts (a bonnetal darknet53.tar.gz, a SpareNet cls_model_39.pth);
     ``python -m r2dm_tpu_torch.sample_and_save`` (b8, 16 samples, 4 DDIM
     steps; 400 GN + 384 conv launches), ``evaluate`` twice on 16 synthetic
     real scans (a finite JSON, the second run from the real-set cache and
     equal to 1e-6, the host seconds of each Fréchet distance) and
     ``completion_demo`` with the RangeNet-53 labels (T=2, r=2, j=1 at b4;
     150 GN + 144 conv launches; the figure's size);
 10. the extractors at 64x1024: RangeNet-53, PointNet and BEV ms an image
     at b8 and b64 (strict fp32), RangeNet-53's FLOPs and share of the fp32
     and TF32 peaks, the extraction's peak memory per image against
     evaluate.MAX_EXTRACT_PIXELS (fails above 70 % of the card), chunked
     extraction against one batch, the card's features against the CPU's,
     and the features and time with TF32 allowed (printed only);
 11. gradient accumulation and bf16 gradients: ``python -m
     r2dm_tpu_torch.train`` at config H b8 with
     ``--training.gradient_accumulation_steps 2`` for 3 micro-steps, then
     resumed for 1 (exact 50 GN + 96 conv launches a micro-step; the
     checkpoint's optax MultiSteps state at mini_step 1 with AdamW count 1,
     then count 2); one b8 ``grad_bf16`` step, kernel path against plain
     path (gradient relative L2 <= TRAIN_REL_L2, 50 + 96 launches), and its
     step time and peak memory beside the fp32-gradient step's;
 12. the data axis: one rank in this process (the trainer for 4 steps at b8,
     then under NCCL, the default backend on CUDA, for 2), and two ranks
     on this one card, one pair of processes each with RANK, WORLD_SIZE=2,
     LOCAL_RANK=0 calling init_process_group("gloo") and then, in turn,
     the trainer (4 steps at global b8, b4 a rank; exact 50 + 96 launches a
     step on each rank; the loss each step and the weights' updates against
     the one rank), sample_and_save (16 samples: phase 9's files) and
     evaluate (phase 9's JSON). Two ranks share the card: a correctness
     check, not a scaling number. The pair has a deadline
     (RANK_TIMEOUT_S), so a rank that hangs fails the phase;
 13. reflow: ``r2dm_tpu_torch.reflow`` on the random config-H network as a
     flow checkpoint, 16 pairs of 4 teacher steps at b8 (400 GN + 384 conv
     launches) and 4 fine-tune steps (200 GN + 384 conv), its seconds and
     peak memory; the written checkpoint loads through setup_model and a
     1-step euler sample at b8 is finite;
 14. the int8 (W8A8) lane on phase 4's network: the sites it quantizes in a
     b8 forward (INT8_SITES, the JAX package's count), one forward with
     exact launches (53 absmax reductions, quantize passes and s8 convs, 50
     GN, no bf16 conv) within JAX's gate of the bf16 forward, a DDIM-16 b8
     chain (the lane's main path: counters zeroed before, read after),
     ``generate --int8`` (b2) and ``sample_and_save`` under R2DM_TPU_INT8
     (b8); at every site shape the absmax (exact), the quantize pass (s8
     bit for bit) and the s8 conv (s32 sums, fp32 and bf16 outputs bit for
     bit) against their plain versions, each timed beside its bound and
     plain version (the conv also beside the bf16 ring-conv kernel, with
     its TOPS, registers and spills); a NaN in x giving an all-NaN output
     on the card as from the plain version; a b8 and a b256 forward's
     device time on both lanes;
 15. the LiDARGen RefineNet at its published width (base 128, (1, 2, 2, 2),
     64x1024) on random weights: setup_model from a reference-layout .pth
     and a msgpack, a b8 forward bf16 against fp32 (relative L2 <= 2e-2)
     with its conv FLOPs, DDIM-16 b8, ``generate`` b2, ``train`` for 4 + 2
     resumed steps at b8 on the synthetic set, the train step's ms and peak
     memory; no hand-written kernel runs there (every counter 0).
Then (phase 16, and its kernel checks right after phase 3) the width axis,
``--mesh 1x2``: two gloo ranks on this one card (a correctness check, no
scaling number), each holding 512 of the 1024 columns. The ring conv's halo'd
form at every ResidualBlock shape with W halved (max|err| <= 1e-2 max|ref|)
and the GroupNorm stats + apply pair at every GN shape (the fp32 sums to
1e-5, the output rtol = atol = 2e-2), each timed beside its bound, plain
version and the one-launch form; then in the ranks one b8 forward against
one rank (relative L2 <= 1e-2, 48 halo'd convs and 50 + 50 GN stats/apply
launches a rank, no ring-form conv and no one-launch GN), the width
collectives' host time (gloo on one card: no scaling figure), each step of a
DDIM-4 chain fed one rank's x_t (the forward <= 1e-2), the DDIM-4 chain
through ``DDPM.sample(world=)`` (its launches the width axis's main path)
and ``sample_and_save --mesh 1x2`` on phase 9's seeds against one rank
within WIDTH_SPREAD times one rank's kernel-vs-plain distance on the same
chain, and ``bench --mesh 1x2`` (b8, 2 steps; its line's unit "img/s
aggregate (2 dev)"); then the int8 lane under ``--mesh 1x2``: every site of
a b8 forward fed a rank's columns (the s8 layout, the absmax and the output
bit for bit against one rank), a NaN in one rank's columns, a b8 forward
(53 absmax + 53 halo'd quantize + 53 s8 conv and 50 + 50 GN launches a
rank), a DDIM-4 chain and ``sample_and_save`` under R2DM_TPU_INT8 against
one rank within WIDTH_SPREAD times the lane's kernel-vs-plain distance, and
``bench --mesh 1x2`` under R2DM_TPU_INT8; then the LiDARGen RefineNet at
its published width (phase 15's random weights) under ``--mesh 1x2``: a b8
forward in fp32 (TF32 off) within REFINENET_WIDTH_FP32_REL_L2 of one rank,
its collectives a forward (REFINENET_WIDTH_COLLECTIVES) and their host
seconds, and the bf16 forward and a bf16 DDIM-4 chain through
``DDPM.sample(world=)`` within WIDTH_SPREAD times one rank's bf16-vs-fp32
distance on the same input, no hand-written launch. Its kernel checks also hold the
halo'd conv at its dx shapes and the int8 lane's halo'd quantize pass at
every site shape (bit for bit), each timed. Last, the width axis for
training: one b8 loss + backward on each rank's columns against one rank's
kernel path within WIDTH_SPREAD times that path's distance from its plain
path (96 halo'd convs and 50 + 50 GN launches a rank, the collectives'
calls and host seconds), and ``python -m r2dm_tpu_torch.train
--training.mesh_shape 1,2`` at config H, b8, for WIDTH_TRAIN_STEPS steps
against one rank's trainer; and the same two for the RefineNet: one bf16 b8
loss + backward on the ranks' columns within TRAIN_REL_L2 of one rank's,
with its collectives and peak memory a rank, and the trainer with
``--model.architecture refinenet`` for WIDTH_TRAIN_STEPS steps (the loss
each step within TRAIN_REL_L2, the updates within TWO_RANK_UPDATE_REL), no
hand-written launch. Phase 17 runs ``python -m
r2dm_tpu_torch.validate_pretrained`` on phase 4's checkpoint with phase 9's
extractor files (``--skip_reference`` unless $R2DM_REFERENCE_DIR names the
original PyTorch code): every stage ok, and its sample stage's exact
launches (8 DDPM steps at b2: 400 GN + 384 conv). Phase 18 runs both
relative-quality protocols, ``python -m r2dm_tpu_torch.ddim_quality_check``
and ``flow_quality_check``, at config H and full width with the scripts'
full-size spec lists and QUALITY_ENV's cuts (8 train steps at b32, 8 reflow
fine-tune steps after the 1024 teacher pairs of 32 euler steps, 8 samples a
leg), each on a fresh workdir, their legs in this process
(``quality_leg_runner``): every leg runs, with its seconds and exact launches
(50 GN + 96 conv a train or fine-tune step, 50 + 48 a forward of a sample
leg or of the reflow teacher, none in evaluate); each table has the
scripts' key, tags and six rows, every value finite but the BEV MMD of a leg
with an empty scan (NaN there, as in the reference); then each protocol
again, as a process on the same workdir, runs no leg, touches no file and
prints the same table.
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
TRAIN_STEPS, RESUMED_STEPS = 10, 2  # python -m r2dm_tpu_torch.train in the training phase
# kernel path against plain path, one config-H b8 loss + backward: relative
# L2 of the flattened gradient (the forward's limit; see PERF.md)
TRAIN_REL_L2 = 2e-2
ACCUM_STEPS, ACCUM_MICRO_STEPS = 2, 3  # phase 11: k, then the micro-steps before the resume
RANK_TIMEOUT_S = 240  # phase 12: the deadline of each group of rank processes
# phase 12, two ranks (b4 each) against one (b8), both bf16 networks: the
# loss each step, relative (6.4e-8 measured: each sample's forward is the
# same, the batch mean sums in another order); the relative L2 of the
# weights' updates after 4 steps (2.6e-3 measured: the all-reduced
# gradients round otherwise, and Adam moves an entry near 0 by up to lr);
# the samples, max |diff| in metres (0 measured: b8 batches both ways,
# per-seed generators). NVIDIA H100 80GB HBM3, 700 W.
TWO_RANK_LOSS_REL, TWO_RANK_UPDATE_REL, TWO_RANK_SAMPLE_ATOL = 1e-5, 2e-2, 1e-5
REFLOW_ARGS = {"num_pairs": 16, "teacher_steps": 4, "batch_size": B, "train_steps": 4}
# phase 16, the width axis: two gloo ranks on this card, --mesh 1x2, each
# holding half of every image's 1024 columns. One network forward and each
# step of a DDIM-4 chain fed one rank's x_t: relative L2 against one rank
# (the forward's limit). A free-running bf16 chain is chaotic at its first
# step (t = 1: x_0 = (x - sigma eps) / alpha, 1/alpha = 1800, then clipped,
# so a rounding of eps flips a pixel between -1 and 1): any other rounding
# moves the samples, the port's kernels against their plain versions too.
# So the sharded DDIM-4 chain and sample_and_save's files are held against
# one rank within WIDTH_SPREAD times the distance of one rank's kernel path
# from its plain path on the same chain, measured in the same run.
WIDTH_MESH = "1x2"
WIDTH_FORWARD_REL_L2 = 1e-2
WIDTH_DDIM_STEPS = 4
WIDTH_SPREAD = 1.5
# the width axis for training: the trainer's steps under --mesh 1x2 (its
# loss each step held at TRAIN_REL_L2 and its weights' updates at
# TWO_RANK_UPDATE_REL against one rank's trainer); one step's loss and
# gradient held at WIDTH_SPREAD times one rank's kernel-vs-plain distance
WIDTH_TRAIN_STEPS = 3
# the LiDARGen RefineNet under the width axis (phase 16 and the width
# training phase; REFINENET_FLAGS, seed 0 as phase 15): a rank's
# collectives a forward, 83 halo exchanges (72 circular convs with a margin,
# in_conv and out_conv, 8 max pools, the upsample) and 34 sums (2 for each
# of the 17 InstanceNorm++); the fp32 forward (TF32 off) against one rank
# (the fp64 sums of the norms' statistics round otherwise than one rank's
# fp32 mean and variance)
REFINENET_WIDTH_COLLECTIVES = 83 + 34
REFINENET_WIDTH_FP32_REL_L2 = 1e-4
# phase 18, the relative-quality protocols (python -m r2dm_tpu_torch.
# {ddim,flow}_quality_check) at config H, full width, with the scripts'
# full-size spec lists, cut in depth: 8 train and 8 reflow fine-tune steps,
# 8 samples a leg; the synthetic set at the scripts' train batch (32: the
# loader needs a batch of scans)
QUALITY_ENV = {"R2DM_QUALITY_TRAIN_STEPS": "8", "R2DM_QUALITY_REFLOW_STEPS": "8", "R2DM_SYNTH_SCANS": "32"}
QUALITY_SAMPLES = 8
# every batch at which this script runs the network: generate b2, RePaint
# b4, the other paths b8, the memory probe b32; one forward at each is held
# against the plain path
FORWARD_BATCHES = (2, 4, B, 4 * B)
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
# the int8 lane at config H: the convs the JAX package quantizes (the 48
# ResidualBlock convs, in_conv, out_conv and the three up convs; counted
# against JAX on a tiny net in tests/test_torch_port_quant.py), each one s8
# conv launch and one absmax launch; its main path is a DDIM chain of
# INT8_DDIM_STEPS steps at b8
INT8_SITES = 48 + 2 + 3
INT8_DDIM_STEPS = 16

# config H, batch 8: (C, H, W) of every GroupNorm input. 64x1024x128 is the
# u_block1 concat input; 8x128x512 / 8x128x256 are also the attention norms.
GN_SHAPES = [(64, 64, 1024), (128, 64, 1024), (128, 32, 512), (256, 32, 512),
             (64, 32, 512), (256, 16, 256), (512, 16, 256), (128, 16, 256),
             (512, 8, 128), (256, 8, 128)]
# every (C_in, F, H, W) of a config-H ResidualBlock conv, with its count per
# network forward (conv1 and conv2 of 24 blocks = 48 launches; a train step
# launches each again at (F, C_in, H, W) for its input gradient)
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
# config H, batch 8: (C_in, F, H, W) of each down conv's input (d_block2-4;
# conv∘FIR composed on the main path) and of each up conv's FIR input
# (u_block4-2; composed only under FUSED_RESAMPLE "up"/"both")
DOWN_SHAPES = [(64, 128, 64, 1024), (128, 256, 32, 512), (256, 512, 16, 256)]
UP_SHAPES = [(256, 256, 8, 128), (128, 128, 16, 256), (64, 64, 32, 512)]
SOURCES = {
    "fused_group_norm_silu": ("r2dm_tpu_torch/csrc/gn_silu.cu", "r2dm_tpu/ops/pallas_gn.py:107"),
    "fused_act_ringconv": ("r2dm_tpu_torch/csrc/act_ringconv.cu", "r2dm_tpu/ops/pallas_resconv.py:174"),
    # the int8 lane replaces an XLA int8 conv, its absmax and its quantization,
    # not a Pallas kernel
    "ring_conv_w8a8": ("r2dm_tpu_torch/csrc/w8a8_ringconv.cu", "r2dm_tpu/ops/quant.py:78"),
    "act_absmax": ("r2dm_tpu_torch/csrc/w8a8_ringconv.cu", "r2dm_tpu/ops/quant.py:59"),
    "act_quantize": ("r2dm_tpu_torch/csrc/w8a8_ringconv.cu", "r2dm_tpu/ops/quant.py:63"),
    # the width axis's cross-rank forms of the two TPU kernels (GSPMD shards
    # the same Pallas calls there)
    "act_ringconv_halo": ("r2dm_tpu_torch/csrc/act_ringconv.cu", "r2dm_tpu/ops/pallas_resconv.py:174"),
    "gn_stats": ("r2dm_tpu_torch/csrc/gn_silu.cu", "r2dm_tpu/ops/pallas_gn.py:107"),
    "gn_apply": ("r2dm_tpu_torch/csrc/gn_silu.cu", "r2dm_tpu/ops/pallas_gn.py:107"),
    # the int8 lane's quantize pass under the width axis
    "act_quantize_halo": ("r2dm_tpu_torch/csrc/w8a8_ringconv.cu", "r2dm_tpu/ops/quant.py:63"),
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


def host_syncs(torch, fn) -> list:
    """Where ``fn`` makes the host wait for the card (sync debug mode), as
    file:line; PyTorch's one-time notice that the mode is a prototype is
    not a sync."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return ["/".join(w.filename.split(os.sep)[-3:]) + f":{w.lineno}" for w in caught
            if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]


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
                "igmma": sum("IGMMA" in line for line in sass.stdout.splitlines()),
                "kernels": ptxas_kernels(build.build_log(name))}
        print(f"build {name}: {json.dumps(info)}")
        if name == "act_ringconv" and info["hgmma"] == 0:
            raise RuntimeError("the ring-conv library has no HGMMA instruction: wgmma was not compiled")
        if name == "w8a8_ringconv" and info["igmma"] == 0:
            raise RuntimeError("the s8 ring-conv library has no IGMMA instruction: wgmma s8 was not compiled")
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
        print(f"act_ringconv ok at (B, H, W, C_in, F) = {(B, H, W, C, Fo)}, "
              f"tile {act_ringconv.tile_variant(B, H, W, C, Fo, act_ringconv.sm_count(x.device))}")
    torch.cuda.synchronize()
    return worst


def _two_op_down(torch, x, k, bias, fir):
    """The two-op down path the network runs with FUSED_RESAMPLE off: the
    ring conv (cuDNN) in x's dtype, then the FIR downsample (``fir``, the
    filter on the card)."""
    import torch.nn.functional as F

    from r2dm_tpu_torch.ops.pad import ring_pad
    from r2dm_tpu_torch.ops.resample import downsample2x

    y = F.conv2d(ring_pad(x, 1).permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), bias.to(x.dtype))
    return downsample2x(y.permute(0, 2, 3, 1).contiguous(), fir)


def _two_op_up(torch, h, k, bias, fir):
    import torch.nn.functional as F

    from r2dm_tpu_torch.ops.pad import ring_pad
    from r2dm_tpu_torch.ops.resample import upsample2x

    u = upsample2x(h, fir)
    y = F.conv2d(ring_pad(u, 1).permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), bias.to(h.dtype))
    return y.permute(0, 2, 3, 1).contiguous()


def _w2c_kernel(torch, k):
    """(3, 3, C, F) HWIO -> the (3, 2, 2C, 2F) block kernel of a 3x3 ring
    conv on width-pair-merged input (r2dm_tpu/ops/w2c.py:126-157)."""
    z = torch.zeros_like(k[:, 0])
    tap0 = torch.cat([torch.cat([k[:, 0], z], -1), torch.cat([k[:, 1], k[:, 0]], -1)], -2)
    tap1 = torch.cat([torch.cat([k[:, 2], k[:, 1]], -1), torch.cat([z, k[:, 2]], -1)], -2)
    return torch.stack([tap0, tap1], dim=1)


def phase_resample(torch):
    """conv∘FIR at config H, b8: at each down shape the composed conv
    (ops/fused_resample.py, the main path's) against the two-op form in bf16
    (relative L2 <= 2e-2) and fp32 (max|err| <= 1e-4 max|ref|, TF32 off),
    and each form's device time; the composed up path the same way at the
    up shapes. Then the W2C record: a cuDNN 3x2 conv on the width-merged
    (B, 64, 512, 128) level-1 tensor against the port's ring-conv kernel on
    the NHWC (B, 64, 1024, 64) one, at b1 and b8, after checking that the
    two compute the same function."""
    import torch.nn.functional as F

    from r2dm_tpu_torch.ops import act_ringconv
    from r2dm_tpu_torch.ops import fused_resample as fr
    from r2dm_tpu_torch.ops.pad import ring_pad
    from r2dm_tpu_torch.ops.resample import fir_kernel

    torch.backends.cudnn.allow_tf32 = False
    out = {"down": [], "up": []}
    for kind, shapes, composed, two_op, up in (("down", DOWN_SHAPES, fr.conv_then_downsample, _two_op_down, 1),
                                                ("up", UP_SHAPES, fr.upsample_then_conv, _two_op_up, 2)):
        firs = {dt: fir_kernel(up=up).to("cuda", dt) for dt in (torch.bfloat16, torch.float32)}
        for (C, Fo, H, W) in shapes:
            rec = {"cin": C, "f": Fo, "h": H, "w": W}
            for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
                x = randn(torch, (B, H, W, C), 30, dtype)
                k = randn(torch, (3, 3, C, Fo), 31, scale=(9 * C) ** -0.5).to(dtype)
                bias = randn(torch, (Fo,), 32, scale=0.1)
                fir = firs[dtype]
                with torch.inference_mode():
                    y, ref = composed(x, k, bias).float(), two_op(torch, x, k, bias, fir).float()
                    rec[f"{name}_rel_l2"] = ((y - ref).norm() / ref.norm()).item()
                    rec[f"{name}_max_err_over_max_ref"] = ((y - ref).abs().max() / ref.abs().max()).item()
                    if dtype == torch.bfloat16:
                        rec["composed_ms"] = graph_ms(torch, lambda: composed(x, k, bias))
                        rec["two_op_ms"] = graph_ms(torch, lambda: two_op(torch, x, k, bias, fir))
                        flops = 2 * 9 * C * Fo * B * H * W * (4 if kind == "up" else 1)
                        rec["composed_tflops"] = flops / rec["composed_ms"] / 1e9
            print(f"conv∘FIR {kind} b{B} {json.dumps(rec)}", flush=True)
            if not (rec["bf16_rel_l2"] <= 2e-2 and rec["fp32_max_err_over_max_ref"] <= 1e-4):
                raise AssertionError(f"conv∘FIR {kind} at {(C, Fo, H, W)}: {rec}")
            out[kind].append(rec)
    total = {kind: {f: sum(r[f] for r in recs) for f in ("composed_ms", "two_op_ms")} for kind, recs in out.items()}
    print(f"conv∘FIR b{B}, the three of each kind: {json.dumps(total)}")

    # the W2C record: level 1 (64 -> 64 at 64x1024), merged against NHWC
    w2c = {}
    for b in (1, B):
        x = randn(torch, (b, 64, 1024, 64), 33, torch.bfloat16)
        k = randn(torch, (3, 3, 64, 64), 34, scale=(9 * 64) ** -0.5)
        bias = randn(torch, (64,), 35, scale=0.1)
        km = _w2c_kernel(torch, k.to(torch.bfloat16)).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bm = torch.cat([bias, bias]).to(torch.bfloat16)
        xm = x.reshape(b, 64, 512, 128)  # the aligned merge is this reshape

        def merged():  # aligned in, offset out: ring pad one merged column on the left
            return F.conv2d(ring_pad(xm, (1, 0, 1, 1)).permute(0, 3, 1, 2), km, bm)

        def nhwc():
            return act_ringconv.fused_act_ringconv(x, None, None, k, bias, apply_act=False)

        with torch.inference_mode():
            y = nhwc().float()
            ym = merged().permute(0, 2, 3, 1).reshape(b, 64, 1024, 64).float()
            rel = ((ym - torch.roll(y, 1, dims=2)).norm() / y.norm()).item()
            w2c[b] = {"merged_cudnn_3x2_ms": graph_ms(torch, merged), "nhwc_kernel_ms": graph_ms(torch, nhwc),
                      "rel_l2": rel}
        print(f"w2c record b{b}: {json.dumps(w2c[b])}", flush=True)
        if not rel <= 2e-2:
            raise AssertionError(f"the merged 3x2 conv computes another function: relative L2 {rel}")
    return {"resample": out, "totals": total, "w2c": w2c}


def phase_main(torch, tmp):
    from r2dm_tpu_torch import config as config_lib
    from r2dm_tpu_torch import setup_model
    from r2dm_tpu_torch.inference import build_model, model_coords
    from r2dm_tpu_torch.models import layers
    from r2dm_tpu_torch.ops import fused_resample

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
    path = os.path.join(tmp, "r2dm-h-random.pth")  # kept for the serving phase
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

    ddpm.sample(batch_size=B, num_steps=1, mode="ddim", seeds=range(B))  # warm-up: captures the forward's graph
    # the main path's kernels as they ran on the card: its forwards replay a
    # CUDA graph, which launches them with no wrapper call
    with device_launches(torch) as ran:
        x = ddpm.sample(batch_size=B, num_steps=16, mode="ddim", seeds=range(B))
        x2 = ddpm.sample(batch_size=B, num_steps=4, mode="ddpm", seeds=range(B, 2 * B))
    launches = ran.counts
    forwards = 16 + 4
    # per forward: 48 ResidualBlock norms and 2 attention norms through the
    # whole function, 48 convs without their prologue
    expected = launches_of(50 * forwards, 48 * forwards)
    print(f"main path launches on the card {json.dumps(launches)} (expected {json.dumps(expected)})")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    ddim_runs = []  # three timed runs (host clock); the median is reported
    for _ in range(3):
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

    # one network forward, kernel path against plain path, at each of
    # FORWARD_BATCHES: both kernels at every shape a path gives them
    rels = {}
    for b in FORWARD_BATCHES:
        xin = randn(torch, (b, 64, 1024, 2), 9)
        cond = torch.linspace(-5.0, 5.0, b, device="cuda")
        with torch.inference_mode():
            y_kernel = ddpm.model(xin, cond)
            with _plain_layers():
                y_plain = ddpm.model(xin, cond)
        rels[b] = ((y_kernel - y_plain).norm() / y_plain.norm()).item()
        del y_kernel, y_plain
    print(f"network forward, kernel path vs plain path: relative L2 by batch {json.dumps(rels)} (limit 2e-2)")
    if not all(r <= 2e-2 and math.isfinite(r) for r in rels.values()):
        raise AssertionError(f"kernel path vs plain path relative L2 {rels}")
    # one forward at b8 (it replays the main path's graph) and one at b256
    # (eager, over forward_graph.MAX_GRAPH_PIXELS): the 48 ring convs split
    # over the tile variants as ops/act_ringconv.py::tile_variant predicts,
    # read from the kernels that ran; at b256 the three down convs composed
    # with their FIR filter (layers.FUSED_RESAMPLE "down"), the up path in
    # two ops, read from the composed convs' calls
    from r2dm_tpu_torch.ops import act_ringconv

    for b in (B, 256):
        xin = randn(torch, (b, 64, 1024, 2), 10)
        cond = torch.linspace(-5.0, 5.0, b, device="cuda")
        fused_resample.conv_then_downsample.calls = fused_resample.upsample_then_conv.calls = 0
        with torch.inference_mode(), device_launches(torch) as ran:
            ddpm.model(xin, cond)
        got = {t: ran.tiles.get(t, 0) for t in act_ringconv.TILES}
        want = dict.fromkeys(act_ringconv.TILES, 0)
        for (C, Fo, H, W), count in CONV_SHAPES.items():
            want[act_ringconv.tile_variant(b, H, W, C, Fo, act_ringconv.sm_count(xin.device))] += count
        print(f"ring-conv launches of one b{b} forward by tile variant {json.dumps(got)} (predicted "
              f"{json.dumps(want)}; all {ran.counts['fused_act_ringconv']})")
        if got != want or ran.counts["fused_act_ringconv"] != 48:
            raise AssertionError(f"b{b} forward: ring-conv launches by tile {got} != {want}")
        del xin
    composed = {"conv_then_downsample": fused_resample.conv_then_downsample.calls,
                "upsample_then_conv": fused_resample.upsample_then_conv.calls}
    print(f"composed resample calls of the b256 forward {json.dumps(composed)} (expected 3 down, 0 up; "
          f"FUSED_RESAMPLE = {layers.FUSED_RESAMPLE!r})")
    if composed != {"conv_then_downsample": 3, "upsample_then_conv": 0}:
        raise AssertionError(f"the down path did not run composed: {composed}")
    img_s = B / ddim_s
    print(f"ddim16 b{B}: runs {json.dumps(ddim_runs)} s, median {ddim_s:.4f} s, {img_s:.4f} img/s")
    return {"launches": launches, "ddim16_img_s": img_s, "ddim16_s": ddim_s, "rel_l2": rels, "ddpm": ddpm,
            "ckpt": path, "ddim16": x}


def _png_size(path: str) -> tuple[int, int]:
    """(height, width) from a PNG's header; raises if it is not a PNG."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return int.from_bytes(head[20:24], "big"), int.from_bytes(head[16:20], "big")


def phase_serving(torch, main_out, tmp):
    """Every other serving path at full config-H width, from phase_main's
    random-weight checkpoint: each path's seconds and launch counts (50 GN,
    48 conv a forward), and the peak memory per image that sets
    DDPM.MAX_BATCH_PIXELS."""
    import dataclasses

    import numpy as np

    from r2dm_tpu_torch import bench, setup_model
    from r2dm_tpu_torch.inference import DDPM, build_diffusion

    ddpm = main_out["ddpm"]
    H, W = ddpm.sampling_shape[:2]
    seconds = {}

    def family(timestep_type):
        cfg = dataclasses.replace(ddpm.cfg, diffusion=dataclasses.replace(ddpm.cfg.diffusion, timestep_type=timestep_type))
        return DDPM(build_diffusion(cfg, ddpm.model), cfg)

    def run(name, forwards, fn, limit=1.02):
        """Run one path under device_launches (its seconds with the
        profiler on); check the kernels that ran and that its output is
        finite with max|x| <= limit."""
        with device_launches(torch) as ran:
            t0 = time.time()
            out = fn()
            torch.cuda.synchronize()
            seconds[name] = time.time() - t0
        launches = ran.counts
        expected = launches_of(50 * forwards, 48 * forwards)
        x = out if isinstance(out, torch.Tensor) else None
        peak = x.abs().max().item() if x is not None else float("nan")
        print(f"path {name}: {seconds[name]:.3f} s, {forwards} forwards, launches {json.dumps(launches)}"
              + (f", shape {list(x.shape)}, max|x| {peak:.4f}" if x is not None else ""))
        if launches != expected:
            raise AssertionError(f"{name}: launch counts {launches} != {expected}")
        if x is not None and not (bool(torch.isfinite(x).all()) and peak <= limit):
            raise AssertionError(f"{name}: non-finite values or max|x| {peak} > {limit}")
        return out

    seeds = range(B)
    run("dpmpp_2m 8 steps b8", 8, lambda: ddpm.sample(B, 8, mode="dpmpp_2m", seeds=seeds))
    flow = family("flow")  # unclipped ODE: random weights leave [-1, 1]
    run("flow euler 4 steps b8", 4, lambda: flow.sample(B, 4, mode="euler", seeds=seeds), limit=1e3)
    run("flow midpoint 2 steps b8", 4, lambda: flow.sample(B, 2, mode="midpoint", seeds=seeds), limit=1e3)
    discrete = family("discrete")
    run("discrete ddpm 4 steps b8", 4, lambda: discrete.sample(B, 4, mode="ddpm", seeds=seeds))
    run("discrete ddim 4 steps b8", 4, lambda: discrete.sample(B, 4, mode="ddim", seeds=seeds))
    # the stack starts at x_T ~ N(0, 1); the range check is on its last step
    xs = run("return_all ddim 4 steps b8", 4,
             lambda: ddpm.sample(B, 4, mode="ddim", seeds=seeds, return_all=True), limit=math.inf)
    if tuple(xs.shape) != (5, B, 2, H, W) or not xs[-1].abs().max().item() <= 1.02:
        raise AssertionError(f"return_all: shape {tuple(xs.shape)}, max|x_0| {xs[-1].abs().max().item()}")
    last = ddpm.sample(B, 4, mode="ddim", seeds=seeds)
    gap = (xs[-1] - last).abs().max().item()
    print(f"return_all[-1] against sample: max|diff| {gap:.3e} (limit 1e-3)")
    if not gap <= 1e-3:
        raise AssertionError(f"return_all[-1] differs from sample by {gap}")

    # RePaint, b4, over known scans from the main path's DDIM-16 samples with
    # the four masks of completion_demo.py:70-74 (all, every 4th beam, half
    # the beams, 10 % of the pixels); T=4, r=2, j=1: 3 x 2 + 1 forwards
    rng = np.random.default_rng(0)
    mask = np.zeros((4, 2, H, W), np.float32)
    mask[0] = 1.0
    mask[1, :, ::4] = 1.0
    mask[2] = (rng.uniform(size=(1, H, 1)) < 0.5).astype(np.float32)
    mask[3] = (rng.uniform(size=(1, H, W)) < 0.1).astype(np.float32)
    mask = torch.from_numpy(mask).cuda()
    known = mask * main_out["ddim16"][:4].clamp(-1, 1) + (1 - mask) * -1.0
    out = run("repaint T4 r2 j1 b4", 7, lambda: ddpm.repaint(known, mask, 4, 2, 1, seeds=range(4)))
    err = ((out - known).abs() * mask).max().item()
    print(f"repaint: max|out - known| where mask = 1: {err:.3e} (limit 1e-2)")
    if not err <= 1e-2:
        raise AssertionError(f"repaint: known pixels moved by {err}")

    # python -m r2dm_tpu_torch.generate, in this process so the counters see it
    out_dir = os.path.join(tmp, "generate")
    argv = ["--ckpt", main_out["ckpt"], "--batch_size", "2", "--sampling_steps", "4", "--mode", "ddim", "--seed",
            "0", "--out_dir", out_dir]
    run("python -m r2dm_tpu_torch.generate b2 ddim 4", 4, lambda: _run_cli("r2dm_tpu_torch.generate", argv))
    sizes = {n: _png_size(os.path.join(out_dir, n)) for n in ("samples_img.png", "samples_bev.png")}
    print(f"generate wrote {json.dumps(sizes)}")
    if sizes != {"samples_img.png": (2 * 2 * H, W), "samples_bev.png": (800, 2 * 800)}:
        raise AssertionError(f"generate: PNG sizes {sizes}")
    # the W2C latency layout: the same network on the same kernels, so the
    # same PNGs byte for byte
    w2c_dir = os.path.join(tmp, "generate_w2c")
    argv_w2c = argv[:-1] + [w2c_dir, "--latency_layout"]
    run("python -m r2dm_tpu_torch.generate --latency_layout b2 ddim 4", 4,
        lambda: _run_cli("r2dm_tpu_torch.generate", argv_w2c))
    same = {n: open(os.path.join(out_dir, n), "rb").read() == open(os.path.join(w2c_dir, n), "rb").read()
            for n in sizes}
    print(f"generate --latency_layout against without: PNGs byte for byte equal {json.dumps(same)}")
    if not all(same.values()):
        raise AssertionError(f"generate --latency_layout changed its output: {same}")

    # r2dm_tpu_torch.bench at b8: 2 warm-up steps, 4 DDPM steps, the flow
    # euler-1 line (1 + 2 x FLOW_REPS one-step chains), 2 x 4 DDIM steps
    result = run("r2dm_tpu_torch.bench b8 4 steps 1 trial", 2 + 4 + bench.FLOW_NET_CALLS + 2 * 4,
                 lambda: bench.main(batch=B, steps=4, trials=1, ddim_steps=4))
    flow_keys = {k: result.get(k) for k in ("flow_euler1_img_per_s", "flow_euler1_seconds_median",
                                            "flow_euler1_trials")}
    print(f"bench b8 flow euler-1: {json.dumps(flow_keys)}")
    if not (result["trials"] == 1 and result["value"] > 0 and "ddim4_img_per_s" in result
            and flow_keys["flow_euler1_trials"] == 2
            and all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0 for v in flow_keys.values())):
        raise AssertionError(f"bench: {result}")

    # the .pth exporter's round trip: the checkpoint as a msgpack (both
    # lanes), python -m r2dm_tpu_torch.export_torch_ckpt, setup_model on the
    # .pth: the same forward as the network it came from
    from r2dm_tpu_torch.checkpoint import write_checkpoint
    from r2dm_tpu_torch.config import asdict
    from r2dm_tpu_torch.utils.weights import to_jax

    tree = to_jax(ddpm.model.state_dict())
    pack = write_checkpoint(os.path.join(tmp, "exported.msgpack"), asdict(ddpm.cfg), tree, ema_weights=tree, step=1)
    pth = os.path.join(tmp, "exported.pth")
    _run_cli("r2dm_tpu_torch.export_torch_ckpt", [pack, pth])
    exported, _, _ = setup_model(pth, dtype=torch.bfloat16, device="cuda")
    xin = randn(torch, (2, H, W, 2), 11)
    cond = torch.tensor([0.3, -2.0], device="cuda")
    with torch.inference_mode():
        y_ref, y_exp = ddpm.model(xin, cond), exported.model(xin, cond)
    gap = (y_ref - y_exp).abs().max().item()
    print(f"export_torch_ckpt round trip: max|forward - exported forward| {gap:.3e} (limit 0)")
    if gap != 0.0:
        raise AssertionError(f"the exported .pth gives another forward: {gap}")
    del exported

    # peak memory per image of one DDIM step and of one RePaint step (T=1:
    # one forward, the known pixels blended in), from b32 and b64, against
    # the chunking bound DDPM.MAX_BATCH_PIXELS and the rule that sets it
    # (the largest power of two of images within 70 % of the card); both
    # batches over forward_graph.MAX_GRAPH_PIXELS, so their forwards run
    # eagerly and allocate their activations, as a chunk of that bound does
    probes = {
        "ddim step": lambda b: ddpm.sample(b, 1, mode="ddim", seeds=range(b)),
        "repaint step": lambda b: ddpm.repaint(known[:1].expand(b, -1, -1, -1).contiguous(), mask[3:], 1,
                                               seeds=range(b)),
    }
    peaks, per_image = {}, {}
    for name, probe in probes.items():
        peaks[name] = {}
        for b in (4 * B, 8 * B):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            probe(b)
            torch.cuda.synchronize()
            peaks[name][b] = torch.cuda.max_memory_allocated() - base
        per_image[name] = (peaks[name][8 * B] - peaks[name][4 * B]) / (4 * B)
    m = max(per_image.values())
    total = torch.cuda.get_device_properties(0).total_memory
    bound_images = DDPM.MAX_BATCH_PIXELS // (H * W)
    rule_images = 2 ** int(math.log2(0.7 * total / m))
    print(f"memory of one step: {json.dumps({'peak_bytes': peaks, 'bytes_per_image': per_image})}"
          f"; DDPM.MAX_BATCH_PIXELS = {bound_images} images -> {bound_images * m / 1e9:.2f} GB"
          f" of {total / 1e9:.2f} GB; the rule gives {rule_images} images (0.7 x total / m = {0.7 * total / m:.1f})")
    if not bound_images * m <= 0.7 * total:
        raise AssertionError(f"DDPM.MAX_BATCH_PIXELS ({bound_images} images) passes 70 % of the card")
    print(f"serving paths seconds: {json.dumps(seconds)}")
    return {"seconds": seconds, "bytes_per_image": per_image}


def _random_extractor(torch, build, seed: int):
    """``build()``'s module with PyTorch's default initialisation from
    ``seed`` and non-trivial frozen BN statistics: the extractors' stand-in
    weights (the published files cannot be fetched). Default init keeps
    RangeNet-53's 53 layers of activations bounded, so the features and the
    metrics stay finite."""
    from r2dm_tpu_torch.metrics.extractor.rangenet import FrozenBatchNorm

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                n = m.weight.numel()
                m.weight.copy_(1 + 0.2 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return model.eval()


def _run_cli(module: str, argv: list) -> str:
    """``python -m <module> argv`` in this process (so the launch counters
    see it); returns what it printed."""
    import contextlib
    import io
    import runpy

    out = io.StringIO()
    saved, sys.argv = sys.argv, [module] + argv
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        if e.code not in (0, None):
            raise AssertionError(f"python -m {module} exited with {e.code}:\n{out.getvalue()[-2000:]}")
    finally:
        sys.argv = saved
    return out.getvalue()


def _launches(ops) -> dict:
    return {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}


def launches_of(gn: int, conv: int, s8: int = 0, halo: int = 0, gn_pair: int = 0, s8_halo: int = 0) -> dict:
    """The launch counts a run must read: GroupNorm, the bf16 ring conv, the
    int8 lane's absmax reduction, quantize pass and s8 ring conv (one each a
    quantized conv), and under a width axis the ring conv's halo'd form,
    GroupNorm's stats and apply launches (one each a norm) and the int8
    lane's absmax, halo'd quantize pass and s8 conv (one each a quantized
    conv, ``s8_halo``)."""
    return {"fused_group_norm_silu": gn, "fused_act_ringconv": conv, "ring_conv_w8a8": s8 + s8_halo,
            "act_absmax": s8 + s8_halo, "act_quantize": s8, "act_ringconv_halo": halo, "gn_stats": gn_pair,
            "gn_apply": gn_pair, "act_quantize_halo": s8_halo}


# a hand-written kernel's name in a profiler trace: one of the port's own
# (an anonymous namespace at the top, not ATen's), its template arguments
_OWN_KERNEL = re.compile(r"(?<![\w:])\(anonymous namespace\)::(\w+_kernel)(?:<([^<>]*)>)?(?:\(|$)")
_KERNEL_WRAPPER = {"gn_kernel": "fused_group_norm_silu", "gn_stats_kernel": "gn_stats", "gn_apply_kernel": "gn_apply",
                   "w8a8_ringconv_kernel": "ring_conv_w8a8", "absmax_kernel": "act_absmax"}


def device_kernel(name: str):
    """(wrapper, tile variant) of a kernel in a profiler trace, by the
    wrapper whose call launches it (``launches_of``'s keys), or None for a
    kernel that no wrapper counts (ATen's, cuDNN's, the ring conv's weight
    pack). The ring conv and the quantize pass are templates on kHalo, their
    last argument, which tells the halo'd forms apart; the ring conv's tile
    is Tile<BN, MT>, BM = 128 MT pixels by BN channels."""
    m = _OWN_KERNEL.search(name)
    if m is None:
        return None
    kernel, args = m.group(1), [a.strip() for a in (m.group(2) or "").split(",")]
    if kernel == "act_ringconv_kernel":
        return ("act_ringconv_halo" if args[-1] == "true" else "fused_act_ringconv"), f"m{128 * int(args[1])}n{args[0]}"
    if kernel == "quantize_kernel":
        return ("act_quantize_halo" if args[-1] == "true" else "act_quantize"), None
    wrapper = _KERNEL_WRAPPER.get(kernel)
    return (wrapper, None) if wrapper else None


class device_launches:
    """The hand-written kernels that ran on the card inside the block, from
    a torch.profiler record of its kernels: a forward that replays a CUDA
    graph (models/forward_graph.py) runs them with no wrapper call, so the
    wrappers' own counters do not see them. ``counts`` (``launches_of``'s
    keys) and ``tiles`` (the ring conv's launches by tile variant) are
    filled when the block ends, or by ``stop()``."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile

        self.torch, self.counts, self.tiles = torch, {}, {}
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self.torch.cuda.synchronize()
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.stop()

    def stop(self) -> dict:
        if self.prof is None:
            return self.counts
        self.torch.cuda.synchronize()
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        self.counts.update(launches_of(0, 0))
        for e in prof.events():
            hit = e.device_type == self.torch.autograd.DeviceType.CUDA and device_kernel(e.name)
            if hit:
                self.counts[hit[0]] += 1
                if hit[1]:
                    self.tiles[hit[1]] = self.tiles.get(hit[1], 0) + 1
        return self.counts


def phase_eval(torch, main_out, tmp, card):
    """The evaluation path at config H and full width, on phase_main's random
    U-Net (its config set to the synthetic set) and random extractor weights
    in their published layouts: a bonnetal darknet53.tar.gz and a SpareNet
    cls_model_39.pth. sample_and_save (b8, 16 samples, 4 DDIM steps),
    evaluate twice (the second from the real-set cache, the same JSON), and
    completion_demo with the RangeNet-53 labels, each through ``python -m``
    in this process with exact launch counts."""
    import numpy as np

    from r2dm_tpu_torch import ops
    from r2dm_tpu_torch.metrics import distribution
    from r2dm_tpu_torch.metrics.extractor import pointnet as pn
    from r2dm_tpu_torch.metrics.extractor import rangenet as rn

    H, W = main_out["ddpm"].sampling_shape[:2]
    work = os.path.join(tmp, "eval")
    os.makedirs(work)
    ckpt = torch.load(main_out["ckpt"], map_location="cpu", weights_only=False)
    ckpt["cfg"]["data"]["dataset"] = "synthetic"
    ckpt_path = os.path.join(work, "r2dm-h-random-synthetic.pth")
    torch.save(ckpt, ckpt_path)
    del ckpt
    tar = os.path.join(work, "darknet53.tar.gz")
    rn.save_rangenet_tar(tar, _random_extractor(torch, lambda: rn.RangeNet(backbone=53), 11))
    sd = _random_extractor(torch, lambda: pn.PointNet1(k=16), 12).state_dict()
    sd.update({k.replace("running_var", "num_batches_tracked"): torch.tensor(39) for k in list(sd)
               if k.endswith("running_var")})
    pth = os.path.join(work, "cls_model_39.pth")
    torch.save(sd, pth)
    seconds, path_launches = {}, {}

    # sample_and_save: 2 batches x 4 DDIM steps = 8 forwards
    samples = os.path.join(work, "samples")
    with device_launches(torch) as ran:
        t0 = time.time()
        _run_cli("r2dm_tpu_torch.sample_and_save", ["--ckpt", ckpt_path, "--output_dir", samples, "--batch_size",
                                                    str(B), "--num_samples", str(2 * B), "--num_steps", "4",
                                                    "--mode", "ddim"])
        seconds["sample_and_save"] = time.time() - t0
    launches = path_launches["sample_and_save"] = ran.counts
    expected = launches_of(50 * 8, 48 * 8)
    files = sorted(os.listdir(samples))
    arrays = [np.load(os.path.join(samples, f))["sample"] for f in files]
    valid = float(np.mean([((a[0] > 3) & (a[0] < 70)).mean() for a in arrays]))
    print(f"sample_and_save b{B}, {2 * B} samples, 4 DDIM steps ({card}): {seconds['sample_and_save']:.3f} s, launches "
          f"{json.dumps(launches)} (expected {json.dumps(expected)}), {len(files)} files, BEV-gated points {valid:.3f}")
    if launches != expected:
        raise AssertionError(f"sample_and_save launches {launches} != {expected}")
    if files != [f"samples_{i:010d}.npz" for i in range(2 * B)] or not all(
            a.shape == (5, H, W) and np.isfinite(a).all() for a in arrays):
        raise AssertionError(f"sample_and_save wrote {files}, shapes {[a.shape for a in arrays]}")

    # evaluate, twice: the second run reads the real-set cache; the host
    # seconds of each Fréchet distance by feature width
    fd_s = []
    plain_fd = distribution.compute_frechet_distance

    def timed_fd(f1, f2):
        t = time.time()
        out = plain_fd(f1, f2)
        fd_s.append((f1.shape[1], time.time() - t))
        return out

    argv = ["--ckpt", ckpt_path, "--sample_dir", samples, "--batch_size", str(B), "--rangenet_tar", tar,
            "--pointnet_ckpt", pth]
    saved_env, cwd = os.environ.get("R2DM_SYNTH_SCANS"), os.getcwd()
    os.environ["R2DM_SYNTH_SCANS"] = str(2 * B)
    distribution.compute_frechet_distance = timed_fd
    runs = []
    try:
        os.chdir(work)  # the real-set cache goes to the working directory
        for i in range(2):
            ops.reset_launch_counts()
            t0 = time.time()
            text = _run_cli("r2dm_tpu_torch.evaluate", argv)
            seconds[f"evaluate run {i + 1}"] = time.time() - t0
            [path] = [f for f in os.listdir(work) if f.startswith("samples_") and f.endswith(".json")]
            with open(path) as f:
                runs.append(json.load(f))
            os.replace(path, f"evaluate_{i + 1}.json")
            if (i == 1) != ("found cached real_set_torch_" in text):
                raise AssertionError(f"evaluate run {i + 1}: real-set cache use wrong:\n{text[:2000]}")
            if any(_launches(ops).values()):
                raise AssertionError(f"evaluate launched U-Net kernels: {_launches(ops)}")
        caches = [f for f in os.listdir(work) if f.startswith("real_set_")]
    finally:
        distribution.compute_frechet_distance = plain_fd
        os.chdir(cwd)
        if saved_env is None:
            os.environ.pop("R2DM_SYNTH_SCANS")
        else:
            os.environ["R2DM_SYNTH_SCANS"] = saved_env
    first, second = runs
    values = {f"{s}.{k}": v for s in ("img", "pts", "bev") for k, v in first[s].items()}
    gap = max(abs(second[s][k] - v) / max(abs(v), 1e-30) for s in ("img", "pts", "bev") for k, v in first[s].items())
    print(f"evaluate (RangeNet-53 tar, PointNet .pth, {2 * B} synthetic real scans, {2 * B} samples, b{B}; {card}): "
          f"{json.dumps(values)}, info {json.dumps(first['info'])}; the run from the cache ({caches}) differs by "
          f"{gap:.3e} relative at most (limit 1e-6); seconds {seconds['evaluate run 1']:.1f} and "
          f"{seconds['evaluate run 2']:.1f}; host seconds of the Fréchet distance by feature width {json.dumps(fd_s)}")
    if not (len(values) == 6 and all(math.isfinite(v) for v in values.values())):
        raise AssertionError(f"evaluate: non-finite or missing metrics {values}")
    if (first["info"]["#real"], first["info"]["#fake"]) != (2 * B, 2 * B) or not gap <= 1e-6 \
            or second["info"] != first["info"]:
        raise AssertionError(f"evaluate: info {first['info']} / {second['info']}, repeat gap {gap}")

    # completion_demo with the RangeNet-53 labels: RePaint T=2, r=2, j=1 at
    # b4 = 1 x 2 + 1 forwards
    with device_launches(torch) as ran:
        t0 = time.time()
        try:
            os.chdir(work)  # the figure goes to the working directory
            _run_cli("r2dm_tpu_torch.completion_demo", ["--ckpt", ckpt_path, "--num_steps", "2",
                                                        "--num_resample_steps", "2", "--rangenet_tar", tar])
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        seconds["completion_demo"] = time.time() - t0
    launches = path_launches["completion_demo"] = ran.counts
    expected = launches_of(50 * 3, 48 * 3)
    size = _png_size(os.path.join(work, "completion_T-0002_r-0002_j-0001.png"))
    want = (2 * H + 800 + 2 * H + H + 800 + 5 * 4, 4 * max(W, 800) + 3 * 8)
    print(f"completion_demo T2 r2 j1 b4 with RangeNet-53 labels ({card}): {seconds['completion_demo']:.3f} s, launches "
          f"{json.dumps(launches)} (expected {json.dumps(expected)}), figure {size} (expected {want})")
    if launches != expected or size != want:
        raise AssertionError(f"completion_demo: launches {launches}, figure {size}")
    return {"seconds": seconds, "fd_s": fd_s, "tar": tar, "pth": pth, "work": work, "launches": path_launches,
            "ckpt": ckpt_path, "samples": samples, "json": first}


def phase_eval_measure(torch, eval_out, card):
    """The extractors at full width: ms an image at b8 and b64 (CUDA events,
    strict fp32), the extraction's peak memory per image against
    evaluate.MAX_EXTRACT_PIXELS, RangeNet-53's FLOPs and its share of the
    fp32 and TF32 peaks, the card's features against the CPU's, the features
    and time with TF32 allowed (printed only), and the chunked extraction
    against one batch."""
    import argparse

    import numpy as np

    from r2dm_tpu_torch import evaluate
    from r2dm_tpu_torch.data import make_dataset
    from r2dm_tpu_torch.metrics import bev
    from r2dm_tpu_torch.metrics.extractor import pointnet as pn
    from r2dm_tpu_torch.metrics.extractor import rangenet as rn
    from r2dm_tpu_torch.metrics.extractor import strict_fp32

    rnet, pre = rn.rangenet53(eval_out["tar"], device="cuda")
    pnet = pn.pretrained_pointnet(eval_out["pth"], device="cuda")
    ds = make_dataset("synthetic", None, "all", "spherical-1024")
    planes = np.stack([ds.planes(i) for i in range(B)])  # (B, 64, 1024, 6) [x, y, z, r, d, m]
    imgs = np.concatenate([planes[..., 4:5], planes[..., 0:4]], axis=-1).transpose(0, 3, 1, 2)
    mask = (planes[..., 5:6] * evaluate.gated(planes[..., 4:5])).transpose(0, 3, 1, 2)
    imgs = np.ascontiguousarray(imgs * mask)
    H, W = imgs.shape[2:]
    flops = rn.forward_flops(rnet, H, W)
    out = {"card": card, "rangenet53_gflop_per_image": flops / 1e9}
    for b in (B, 8 * B):
        x = torch.from_numpy(np.tile(imgs, (b // B, 1, 1, 1))).cuda()
        m = torch.from_numpy(np.tile(mask, (b // B, 1, 1, 1))).cuda()
        clouds = (x[:, 1:4] * m).reshape(b, 3, H * W)
        with torch.inference_mode(), strict_fp32():
            xin = pre(x, m)
            rn_ms = cuda_ms(torch, lambda: rnet(xin, "lidargen"), iters=3, warmup=1)
            pn_ms = cuda_ms(torch, lambda: pnet(clouds / evaluate.DATASET_MAX_DEPTH), iters=3, warmup=1)
            bev_ms = cuda_ms(torch, lambda: bev.point_cloud_to_histogram(clouds.transpose(1, 2)), iters=5, warmup=1)
        out[f"b{b}"] = {"rangenet53_ms_per_image": rn_ms / b, "pointnet_ms_per_image": pn_ms / b,
                        "bev_ms_per_image": bev_ms / b,
                        "rangenet53_fp32_peak_share": flops * b / (rn_ms / 1e3) / PEAK_FP32_FLOPS,
                        "rangenet53_tf32_peak_share": flops * b / (rn_ms / 1e3) / PEAK_TF32_FLOPS}
        del x, m, clouds, xin

    # peak memory of one extraction as evaluate runs it, b8 and b64
    ns = argparse.Namespace(rangenet_tar=eval_out["tar"], pointnet_ckpt=eval_out["pth"], allow_random_extractors=False)
    extract = evaluate.build_extractors(ns, torch.device("cuda"))
    peaks = {}
    for b in (B, 8 * B):
        big, big_mask = np.tile(imgs, (b // B, 1, 1, 1)), np.tile(mask, (b // B, 1, 1, 1))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        feats = extract(big, big_mask)
        torch.cuda.synchronize()
        peaks[b] = torch.cuda.max_memory_allocated() - base
    per_image = (peaks[8 * B] - peaks[B]) / (7 * B)
    total = torch.cuda.get_device_properties(0).total_memory
    bound_images = evaluate.MAX_EXTRACT_PIXELS // (H * W)
    out["extract_peak_bytes"] = peaks
    out["extract_bytes_per_image"] = per_image
    out["max_extract_images"] = bound_images
    out["rule_images"] = 2 ** int(math.log2(0.7 * total / per_image))
    # chunked (4 images a chunk) against one batch of 64
    saved = evaluate.MAX_EXTRACT_PIXELS
    evaluate.MAX_EXTRACT_PIXELS = 4 * H * W
    try:
        chunked = extract(big, big_mask)
    finally:
        evaluate.MAX_EXTRACT_PIXELS = saved
    out["chunked_vs_one_batch_max_rel"] = [float(np.abs(c - f).max() / max(np.abs(f).max(), 1e-30))
                                           for c, f in zip(chunked, feats)]

    # card against CPU, strict fp32, the same weights and 2 inputs; then TF32
    x2, m2 = torch.from_numpy(imgs[:2]), torch.from_numpy(mask[:2])

    def feats_of(net_img, net_pts, x, m):
        with torch.inference_mode():
            c = (x[:, 1:4] * m).reshape(len(x), 3, H * W) / evaluate.DATASET_MAX_DEPTH
            return net_img(pre(x, m), "lidargen").float().cpu(), net_pts(c).float().cpu()

    with strict_fp32():
        card_f = feats_of(rnet, pnet, x2.cuda(), m2.cuda())
    cpu_rn, _ = rn.rangenet53(eval_out["tar"], device="cpu")
    cpu_f = feats_of(cpu_rn, pn.pretrained_pointnet(eval_out["pth"], device="cpu"), x2, m2)
    del cpu_rn

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    out["card_vs_cpu_rel_l2"] = {"rangenet53": rel(card_f[0], cpu_f[0]), "pointnet": rel(card_f[1], cpu_f[1])}
    saved_tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_f = feats_of(rnet, pnet, x2.cuda(), m2.cuda())
        x = torch.from_numpy(imgs).cuda()
        m = torch.from_numpy(mask).cuda()
        with torch.inference_mode():
            xin = pre(x, m)
            tf32_ms = cuda_ms(torch, lambda: rnet(xin, "lidargen"), iters=3, warmup=1)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    out["tf32"] = {"rangenet53_ms_per_image_b8": tf32_ms / B,
                   "rel_l2_vs_strict_fp32": {"rangenet53": rel(tf32_f[0], card_f[0]),
                                             "pointnet": rel(tf32_f[1], card_f[1])}}
    out["host_frechet_s"] = eval_out["fd_s"]
    print(f"evaluation extractors at 64x1024 ({card}): {json.dumps(out)}")
    if not bound_images * per_image <= 0.7 * total:
        raise AssertionError(f"evaluate.MAX_EXTRACT_PIXELS ({bound_images} images) passes 70 % of the card")
    if not max(out["card_vs_cpu_rel_l2"].values()) <= 1e-4:
        raise AssertionError(f"card features against CPU features: {out['card_vs_cpu_rel_l2']}")
    if not max(out["chunked_vs_one_batch_max_rel"]) <= 1e-5:
        raise AssertionError(f"chunked extraction against one batch: {out['chunked_vs_one_batch_max_rel']}")
    return out


def phase_breakdown(torch, ddpm):
    """Where one batch-B network forward spends its time: the forward as
    the host drives it, its device time, and each part's device time on the
    inputs it receives in a real forward (captured with forward hooks). The
    down path (conv∘FIR, composed under the default FUSED_RESAMPLE) is also
    timed in two ops, and the whole forward with it in two ops, against the
    composed one (relative L2 <= 2e-2)."""
    from r2dm_tpu_torch.models import layers
    from r2dm_tpu_torch.models.layers import ResidualBlock

    net = ddpm.model
    parts = {"in_conv": net.in_conv, "out_conv": net.out_conv, "time_embedding": net.time_embedding}
    down_blocks = {}
    for name in ("d_block1", "d_block2", "d_block3", "d_block4", "u_block4", "u_block3", "u_block2", "u_block1"):
        blk = getattr(net, name)
        if blk.downsample is not None:
            down_blocks[f"{name}.down"] = blk  # its input is the block's
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

    hooks = [m.register_forward_hook(keep_inputs(n)) for n, m in {**parts, **down_blocks}.items()]
    xin = randn(torch, (B, 64, 1024, 2), 10)
    cond = torch.linspace(-5.0, 5.0, B, device="cuda")
    try:
        with torch.inference_mode():  # the eager body: a replayed forward runs no part's Python, so no hook
            net._forward(xin, cond)
    finally:
        for h in hooks:
            h.remove()
    with torch.inference_mode():
        forward_ms = cuda_ms(torch, lambda: net(xin, cond), iters=5, warmup=2)
        # host time to enqueue one forward, as it replays its CUDA graph and
        # eagerly: below forward_ms, the host keeps the card fed at this batch
        enqueue_ms = {}
        for what, fn in (("replayed", net), ("eager", net._forward)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(xin, cond)
            enqueue_ms[what] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        # operations that block the host until the card drains its queue,
        # in two forwards one after the other and in one 2-step sampling call
        syncs = {}
        for what, fn in (("forward", lambda: net(xin, cond)),
                         ("forward_again", lambda: net(xin, cond)),
                         ("sample_2_steps", lambda: ddpm.sample(B, 2, seeds=range(B)))):
            syncs[what] = host_syncs(torch, fn)
        torch.cuda.synchronize()
        # device time alone (CUDA graphs): of the forward, and of each part
        device_ms = graph_ms(torch, lambda: net(xin, cond), iters=3)
        times = {n: graph_ms(torch, lambda m=parts[n], a=captured[n]: m(*a), iters=3) for n in parts}
        down = {n: graph_ms(torch, lambda b=blk, h=captured[n][0]: b.down(h), iters=3)
                for n, blk in down_blocks.items()}
        y_composed = net(xin, cond)
        saved = layers.FUSED_RESAMPLE
        layers.FUSED_RESAMPLE = False  # read while the graphs are captured
        try:
            down_two_op = {n: graph_ms(torch, lambda b=blk, h=captured[n][0]: b.down(h), iters=3)
                           for n, blk in down_blocks.items()}
            device_two_op_ms = graph_ms(torch, lambda: net(xin, cond), iters=3)
            y_two_op = net(xin, cond)
        finally:
            layers.FUSED_RESAMPLE = saved
    rel = ((y_composed - y_two_op).norm() / y_two_op.norm()).item()
    groups = {"residual blocks": [n for n, m in parts.items() if isinstance(m, ResidualBlock)]}
    for key in ("fir_up", "up_conv", "attention"):
        groups[key] = [n for n in parts if n.endswith(key)]
    groups["in/out conv, time embedding"] = ["in_conv", "out_conv", "time_embedding"]
    summary = {g: sum(times[n] for n in names) for g, names in groups.items()}
    summary["down conv∘FIR, composed"] = sum(down.values())
    summary["rest (concat, casts, encoding)"] = device_ms - sum(summary.values())
    print(f"forward breakdown b{B}: " + json.dumps({
        "forward_ms": forward_ms, "device_ms": device_ms, "device_idle_share": 1.0 - device_ms / forward_ms,
        "host_enqueue_ms": enqueue_ms, "host_syncs": syncs, "device_ms_by_part": summary,
    }, ensure_ascii=False))
    print(f"down path b{B}, composed against two ops (device ms, real inputs): " + json.dumps({
        "composed": down, "two_op": down_two_op, "composed_total": sum(down.values()),
        "two_op_total": sum(down_two_op.values()), "forward_device_ms_composed": device_ms,
        "forward_device_ms_two_op": device_two_op_ms, "forward_rel_l2": rel}))
    if not (math.isfinite(rel) and rel <= 2e-2):
        raise AssertionError(f"forward with the composed down path against two ops: relative L2 {rel}")


def phase_time(torch, launches, train_launches, errs):
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
            "train_launches_per_step": train_launches[name] // TRAIN_STEPS,
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
        # the backward at this conv: dx is the kernel at (F, C_in), dy in and
        # dx out (bound: dy read, dx written, the weight read once; library:
        # cuDNN's dgrad, which the port never calls); dW and d_bias through
        # PyTorch; the norm before it, GN + SiLU backward in PyTorch ops
        dy = randn(torch, (B, H, W, Fo), 22, torch.bfloat16)
        dx_ms = graph_ms(torch, lambda: act_ringconv.ring_conv_input_grad(dy, k))
        # the wrapper's packing of the weight, inside ms on every launch
        sms = act_ringconv.sm_count(x.device)
        tile = act_ringconv.tile_variant(B, H, W, C, Fo, sms)
        pack_ms = graph_ms(torch, lambda: act_ringconv.pack_weight(k, tile))
        dx_plain = graph_ms(torch, lambda: act_ringconv.act_ringconv_plain(
            dy, None, None, k.flip(0, 1).transpose(2, 3), torch.zeros(C, device="cuda"), apply_act=False))
        dyc = dy.permute(0, 3, 1, 2)
        dx_lib = graph_ms(torch, lambda: torch.nn.grad.conv2d_input((B, C, H + 2, W + 2), wt, dyc))
        dw_ms = graph_ms(torch, lambda: act_ringconv.ring_conv_weight_grad(x, dy, torch.float32, torch.float32))
        gn_bwd_ms = graph_ms(torch, lambda: gn_silu.gn_silu_backward(x, a[0], b[0], G, eps, True, x))
        per_shape.append({"cin": C, "f": Fo, "h": H, "w": W, "per_forward": count,
                          "tile": tile, "pack_ms": pack_ms,
                          "dx_tile": act_ringconv.tile_variant(B, H, W, Fo, C, sms), "ms": ms,
                          "act_ms": act_ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                          "tflops": flops / ms / 1e9, "gn_silu_ms": gn_silu_ms, "gn_nosilu_ms": gn_nosilu_ms,
                          "gn_silu_bound_ms": gn_silu_bound, "dx_ms": dx_ms, "dx_plain_ms": dx_plain,
                          "dx_library_ms": dx_lib, "dx_bound_ms": bound, "dw_ms": dw_ms,
                          "gn_silu_backward_ms": gn_bwd_ms,
                          "gn_silu_backward_bound_ms": 3 * x.numel() * 2 / PEAK_BYTES * 1e3})
        if (C, Fo, H, W) == (64, 64, 64, 1024):
            row("fused_act_ringconv", "cuda", ms, plain, nbytes, flops, PEAK_BF16_FLOPS, lib,
                [B, H, W, C, Fo], errs["fused_act_ringconv"])
    total = {k: sum(s[k] * s["per_forward"] for s in per_shape)
             for k in ("ms", "act_ms", "plain_ms", "library_ms", "bound_ms", "gn_silu_ms", "gn_nosilu_ms",
                       "gn_silu_bound_ms", "dx_ms", "dx_plain_ms", "dx_library_ms", "dw_ms", "gn_silu_backward_ms",
                       "gn_silu_backward_bound_ms", "pack_ms")}
    print("ResidualBlock kernels per shape: " + json.dumps({"shapes": per_shape, "per_forward_total": total}))
    for s_ in per_shape:
        print(f"ring conv b{B} {s_['cin']}->{s_['f']} at {s_['h']}x{s_['w']} x{s_['per_forward']} ({s_['tile']}): "
              f"{s_['ms']:.4f} ms, bound {s_['bound_ms']:.4f}, library {s_['library_ms']:.4f}; "
              f"dx ({s_['dx_tile']}) {s_['dx_ms']:.4f}")
    # the 48 convs of a b256 forward (one launch each, timed with events:
    # a graph of 20 would hold 20 outputs of up to 2 GB), each checked
    # against its plain version: b256 gives tile variants b8 does not
    Bb = 256
    per_shape_256 = []
    for (C, Fo, H, W), count in CONV_SHAPES.items():
        x = randn(torch, (Bb, H, W, C), 23, torch.bfloat16)
        k = randn(torch, (3, 3, C, Fo), 24, scale=0.05)
        bias = randn(torch, (Fo,), 25)
        ms = cuda_ms(torch, lambda: act_ringconv.fused_act_ringconv(x, None, None, k, bias, apply_act=False),
                     iters=5, warmup=2)
        with torch.inference_mode():
            ref = act_ringconv.act_ringconv_plain(x, None, None, k, bias, apply_act=False).float()
            err = (act_ringconv.fused_act_ringconv(x, None, None, k, bias, apply_act=False).float()
                   - ref).abs().max().item()
            scale = ref.abs().max().item()
            del ref
        if not err <= 1e-2 * scale:
            raise AssertionError(f"act_ringconv b{Bb} {(C, Fo, H, W)}: max|err| {err:.3e} vs max|ref| {scale:.3e}")
        xp = ring_pad(x, 1).permute(0, 3, 1, 2)
        wt = k.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib = cuda_ms(torch, lambda: F.conv2d(xp, wt, bias.to(torch.bfloat16)), iters=5, warmup=2)
        del xp
        flops = 2 * 9 * C * Fo * Bb * H * W
        nbytes = (Bb * H * W * (C + Fo)) * 2 + 9 * C * Fo * 2 + Fo * 4
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        per_shape_256.append({"cin": C, "f": Fo, "h": H, "w": W, "per_forward": count,
                              "tile": act_ringconv.tile_variant(Bb, H, W, C, Fo, sms), "ms": ms,
                              "library_ms": lib, "bound_ms": bound, "roofline_share": bound / ms,
                              "max_err": err, "max_ref": scale})
        print(f"ring conv b{Bb} {C}->{Fo} at {H}x{W} x{count} ({per_shape_256[-1]['tile']}): {ms:.4f} ms, "
              f"bound {bound:.4f} ({100 * bound / ms:.1f} %), library {lib:.4f}; max|err| {err:.3e} "
              f"of max|ref| {scale:.3e}")
        del x
        torch.cuda.empty_cache()
    total_256 = {k: sum(s[k] * s["per_forward"] for s in per_shape_256)
                 for k in ("ms", "library_ms", "bound_ms")}
    print(f"ResidualBlock convs b{Bb}: " + json.dumps({"shapes": per_shape_256, "per_forward_total": total_256}))
    for b_, tot in ((B, total), (Bb, total_256)):
        print(f"ring conv, the 48 shapes of a b{b_} forward: {tot['ms']:.3f} ms, bound {tot['bound_ms']:.3f} "
              f"({100 * tot['bound_ms'] / tot['ms']:.1f} %), library {tot['library_ms']:.3f}")
    print(f"ring conv, the weight's packing inside those calls, 48 shapes of a b{B} forward: {total['pack_ms']:.3f} ms")
    return rows

def _grads(torch, fn, inputs, dy):
    """Gradients of ``fn(*inputs)`` for the output gradient dy, each input
    a fresh leaf."""
    leaves = [v.detach().clone().requires_grad_() for v in inputs]
    fn(*leaves).backward(dy)
    return [v.grad for v in leaves]


def phase_train_backward(torch):
    """Each kernel's backward against autograd of its plain version, in bf16
    on the card, at every config-H shape: the forward's limits (GN rtol =
    atol = 2e-2; the conv max|err| <= 1e-2 * max|ref|)."""
    from r2dm_tpu_torch.ops import act_ringconv, gn_silu

    G, eps = 8, 1e-6
    worst = {}
    for C, H, W in GN_SHAPES:
        x = randn(torch, (B, H, W, C), 31, torch.bfloat16, offset=0.1)
        dy = randn(torch, (B, H, W, C), 32, torch.bfloat16)
        for per_batch in (False, True):
            aff = (B, C) if per_batch else (C,)
            gain = randn(torch, aff, 33, scale=0.5, offset=1.0)
            shift = randn(torch, aff, 34, scale=0.5)
            for silu in (True, False):
                got = _grads(torch, lambda a, g, b: gn_silu.fused_group_norm_silu(a, g, b, G, eps, silu),
                             (x, gain, shift), dy)
                ref = _grads(torch, lambda a, g, b: gn_silu.fused_group_norm_silu_plain(a, g, b, G, eps, silu),
                             (x, gain, shift), dy)
                for name, o, r in zip(("dx", "d_gain", "d_shift"), got, ref):
                    err = (o.float() - r.float()).abs()
                    if o.shape != r.shape or not bool((err <= 2e-2 + 2e-2 * r.float().abs()).all()):
                        raise AssertionError(f"gn_silu backward {(C, H, W)} {name} per_batch={per_batch} "
                                             f"silu={silu}: max|err| {err.max().item():.3e}")
                    worst[f"gn {name}"] = max(worst.get(f"gn {name}", 0.0), err.max().item())
    print(f"gn_silu backward ok at every GN_SHAPES entry: max|err| {json.dumps(worst)}")
    for (C, Fo, H, W) in CONV_SHAPES:
        x = randn(torch, (B, H, W, C), 35, torch.bfloat16)
        k = randn(torch, (3, 3, C, Fo), 36, scale=(9 * C) ** -0.5)
        bias = randn(torch, (Fo,), 37, scale=0.1)
        dy = randn(torch, (B, H, W, Fo), 38, torch.bfloat16)
        got = _grads(torch, lambda a, kk, b: act_ringconv.fused_act_ringconv(a, None, None, kk, b, apply_act=False),
                     (x, k, bias), dy)
        ref = _grads(torch, lambda a, kk, b: act_ringconv.act_ringconv_plain(a, None, None, kk, b, apply_act=False),
                     (x, k, bias), dy)
        for name, o, r in zip(("dx", "dW", "d_bias"), got, ref):
            err = (o.float() - r.float()).abs().max().item()
            scale = r.float().abs().max().item()
            if o.shape != r.shape or o.dtype != r.dtype or not err <= 1e-2 * scale:
                raise AssertionError(f"act_ringconv backward {(C, Fo, H, W)} {name}: max|err| {err:.3e} "
                                     f"vs max|ref| {scale:.3e}")
            worst[f"conv {name} rel"] = max(worst.get(f"conv {name} rel", 0.0), err / scale)
    # under grad the wrappers return a graph node on the card, and the
    # prologue form, which has no backward, raises
    x = randn(torch, (B, 8, 128, 64), 39, torch.bfloat16).requires_grad_()
    k = randn(torch, (3, 3, 64, 64), 40, scale=0.05)
    ones, zeros = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    if gn_silu.fused_group_norm_silu(x, ones, zeros, G, eps).grad_fn is None or \
            act_ringconv.fused_act_ringconv(x, None, None, k, zeros, apply_act=False).grad_fn is None:
        raise AssertionError("a kernel wrapper returned no grad_fn under autograd")
    try:
        act_ringconv.fused_act_ringconv(x, ones[None].expand(B, 64).contiguous(), zeros[None].expand(B, 64).contiguous(),
                                        k, zeros, apply_act=True)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("fused_act_ringconv(apply_act=True) under autograd did not raise")
    print(f"backward of both kernels ok at every config-H shape: {json.dumps(worst)}")
    torch.cuda.synchronize()
    return worst


def phase_train_step(torch):
    """One config-H b8 loss + backward through the kernel path and through
    the plain path, from the same weights, batch, steps and noise."""
    from r2dm_tpu_torch import ops
    from r2dm_tpu_torch.bench import random_ddpm
    from r2dm_tpu_torch.models import layers
    from r2dm_tpu_torch.ops import fused_resample

    ddpm = random_ddpm(seed=1)
    model, diffusion = ddpm.model.train(), ddpm.diffusion
    g = torch.Generator("cuda").manual_seed(2)
    x_0 = torch.rand((B, 64, 1024, 2), generator=g, device="cuda") * 2 - 1
    steps = torch.rand((B,), generator=g, device="cuda")
    noise = torch.randn((B, 64, 1024, 2), generator=g, device="cuda")

    def loss_and_grad():
        model.zero_grad(set_to_none=True)
        loss = diffusion.p_loss(model, x_0, steps, noise)
        loss.backward()
        return loss.detach(), torch.cat([p.grad.flatten() for p in model.parameters()])

    ops.reset_launch_counts()
    fused_resample.conv_then_downsample.calls = 0
    loss_k, grad_k = loss_and_grad()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    composed = fused_resample.conv_then_downsample.calls
    saved = {n: getattr(layers, n) for n in ("fused_group_norm_silu", "fused_act_ringconv")}
    try:
        layers.fused_group_norm_silu = ops.gn_silu.fused_group_norm_silu_plain
        layers.fused_act_ringconv = ops.act_ringconv.act_ringconv_plain
        loss_p, grad_p = loss_and_grad()
    finally:
        for n, fn in saved.items():
            setattr(layers, n, fn)
    rel_loss = ((loss_k - loss_p).abs() / loss_p.abs()).item()
    rel_grad = ((grad_k - grad_p).norm() / grad_p.norm()).item()
    print(f"train step b{B}, kernel path vs plain path: loss {loss_k.item():.6f} vs {loss_p.item():.6f}, "
          f"relative L2 of the loss {rel_loss:.3e}, of the flattened gradient ({grad_k.numel()} values) "
          f"{rel_grad:.3e} (limit {TRAIN_REL_L2}); launches {json.dumps(launches)}; composed down convs "
          f"{composed} (expected 3)")
    if launches != launches_of(50, 96):
        raise AssertionError(f"one loss + backward launched {launches}, expected 50 GN and 96 conv")
    if composed != 3:
        raise AssertionError(f"the train step ran {composed} composed down convs, expected 3")
    if not (math.isfinite(rel_grad) and rel_loss <= TRAIN_REL_L2 and rel_grad <= TRAIN_REL_L2):
        raise AssertionError(f"kernel path vs plain path: loss {rel_loss}, gradient {rel_grad}")
    del grad_k, grad_p
    return {"ddpm": ddpm, "rel_loss": rel_loss, "rel_grad": rel_grad}


def _train_cli(torch, argv):
    """``python -m r2dm_tpu_torch.train`` in this process, so the launch
    counters see it; returns (seconds, launches)."""
    from r2dm_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.time()
    _run_cli("r2dm_tpu_torch.train", argv)
    torch.cuda.synchronize()
    return time.time() - t0, _launches(ops)


def phase_train_cli(torch, tmp):
    """The training entry point on the synthetic set at config H, b8: 10
    steps, then resumed from its checkpoint for 2 more."""
    import numpy as np

    from r2dm_tpu_torch.checkpoint import load_checkpoint
    from r2dm_tpu_torch.ops import fused_resample

    out = os.path.join(tmp, "train")
    argv = ["--data.dataset", "synthetic", "--training.output_dir", out, "--training.seed", "0",
            "--training.steps_save_image", "100000", "--training.steps_save_model", "100000"]
    saved_env = os.environ.get("R2DM_SYNTH_SCANS")
    os.environ["R2DM_SYNTH_SCANS"] = str(B)
    try:
        fused_resample.conv_then_downsample.calls = 0
        runs = [_train_cli(torch, argv + ["--training.num_steps", str(TRAIN_STEPS)])]
        composed = fused_resample.conv_then_downsample.calls
        first = load_checkpoint(os.path.join(out, "checkpoint.msgpack"))
        runs.append(_train_cli(torch, argv + ["--training.num_steps", str(TRAIN_STEPS + RESUMED_STEPS),
                                              "--training.resume", os.path.join(out, "checkpoint.msgpack")]))
        second = load_checkpoint(os.path.join(out, "checkpoint.msgpack"))
    finally:
        if saved_env is None:
            os.environ.pop("R2DM_SYNTH_SCANS")
        else:
            os.environ["R2DM_SYNTH_SCANS"] = saved_env
    for (seconds, launches), steps in zip(runs, (TRAIN_STEPS, RESUMED_STEPS)):
        expected = launches_of(50 * steps, 96 * steps)
        print(f"python -m r2dm_tpu_torch.train, {steps} steps b{B}: {seconds:.3f} s (build, data, steps, "
              f"checkpoint), launches {json.dumps(launches)} (expected {json.dumps(expected)})")
        if launches != expected:
            raise AssertionError(f"train launches {launches} != {expected}")
    # each step's forward runs the three down convs composed, under autograd
    print(f"train: {composed} composed down convs in {TRAIN_STEPS} steps (expected {3 * TRAIN_STEPS})")
    if composed != 3 * TRAIN_STEPS:
        raise AssertionError(f"train ran {composed} composed down convs, expected {3 * TRAIN_STEPS}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    print(f"train metrics at step 1: {json.dumps(logged[0])}")
    if not (logged[0]["step"] == 1 and math.isfinite(logged[0]["loss"]) and math.isfinite(logged[0]["grad_norm"])):
        raise AssertionError(f"train metrics: {logged}")
    counts = [(c["global_step"], int(c["opt_state"]["1"]["0"]["count"]), int(c["opt_state"]["1"]["2"]["count"]))
              for c in (first, second)]
    if counts != [(TRAIN_STEPS,) * 3, (TRAIN_STEPS + RESUMED_STEPS,) * 3]:
        raise AssertionError(f"(step, adam count, schedule count) after each run: {counts}")
    leaves = _leaves(second["weights"]) + _leaves(second["ema_weights"]) + _leaves(second["opt_state"])
    moved = [np.abs(a - b).max() for a, b in zip(_leaves(first["opt_state"]["1"]["0"]["nu"]),
                                                   _leaves(second["opt_state"]["1"]["0"]["nu"]))]
    if not all(np.isfinite(np.asarray(a)).all() for a in leaves) or max(moved) == 0.0:
        raise AssertionError("the resumed run left non-finite weights or an AdamW state that did not move")
    print(f"train resume: (step, adam count, schedule count) {counts}; checkpoint finite; "
          f"AdamW second moments moved by up to {max(moved):.3e} in the resumed steps")
    return {"seconds": [r[0] for r in runs], "launches": runs[0][1], "loss_step1": logged[0]["loss"]}


def _leaves(node):
    return [x for v in node.values() for x in (_leaves(v) if isinstance(v, dict) else [v])]


def phase_train_time(torch, ddpm):
    """The train step as the trainer runs it (loss, backward, clip, AdamW,
    scheduler, EMA) at config H, b8: device time per step (CUDA events) after
    warm-up, the host's time to enqueue it, and its peak memory."""
    from r2dm_tpu_torch import config as config_lib
    from r2dm_tpu_torch.training import EMAConfig, init_train_state, make_optimizer, make_train_step

    model = ddpm.model
    optimizer, scheduler = make_optimizer(model.parameters(), config_lib.TrainingConfig(lr_warmup_steps=1))
    state = init_train_state(model, optimizer, scheduler)
    step = make_train_step(ddpm.diffusion, optimizer, scheduler, EMAConfig(update_after_step=0, update_every=1))
    g = torch.Generator("cuda").manual_seed(3)
    x_0 = torch.rand((B, 64, 1024, 2), generator=g, device="cuda") * 2 - 1
    for _ in range(3):  # warm-up: AdamW's state, the allocator's pools
        step(state, x_0, g)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    device_ms, enqueue_ms = [], []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        metrics = step(state, x_0, g)
        end.record()
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        device_ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() - base
    loss = metrics["loss"].item()
    med = sorted(device_ms)[len(device_ms) // 2]
    enq = sorted(enqueue_ms)[len(enqueue_ms) // 2]
    out = {"median_step_ms": med, "img_per_s": B / med * 1e3, "step_ms": device_ms, "median_enqueue_ms": enq,
           "host_share": enq / med, "peak_bytes": peak, "resident_bytes": base, "loss": loss}
    print(f"train step b{B} (CUDA events, 3 warm-up steps, 10 timed): " + json.dumps(out))
    if not math.isfinite(loss):
        raise AssertionError(f"train step loss {loss}")
    out["profile"] = _profile_train_step(torch, step, state, x_0, g)
    out["down_path"] = _train_step_down_paths(torch, step, state, x_0, g)
    return out


def _train_step_down_paths(torch, step, state, x_0, g, pairs: int = 8) -> dict:
    """The same train step with the composed down path (FUSED_RESAMPLE
    "down", the composed kernel built in the graph every step) and with the
    two-op form (False), steps alternating so the host's drift falls on
    both alike: the median device ms (CUDA events) and host enqueue ms of
    each. The weights are put back afterwards, so the phases after this
    one see those of the steps before it."""
    import copy

    from r2dm_tpu_torch.models import layers

    saved, weights = layers.FUSED_RESAMPLE, copy.deepcopy(state.model.state_dict())
    times = {"down": ([], []), "two_op": ([], [])}
    try:
        for i in range(2 * pairs + 2):  # the first pair warms the two-op form up
            name = ("two_op", "down")[i % 2]
            layers.FUSED_RESAMPLE = "down" if name == "down" else False
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            loss = step(state, x_0, g)["loss"]
            end.record()
            enqueue = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            if i >= 2:
                times[name][0].append(start.elapsed_time(end))
                times[name][1].append(enqueue)
            if not math.isfinite(loss.item()):
                raise AssertionError(f"train step with the {name} down path: loss {loss.item()}")
    finally:
        layers.FUSED_RESAMPLE = saved
        state.model.load_state_dict(weights)
    out = {name: {"median_step_ms": sorted(d)[pairs // 2], "median_enqueue_ms": sorted(e)[pairs // 2], "step_ms": d}
           for name, (d, e) in times.items()}
    print(f"train step b{B}, the down path composed against two ops ({pairs} steps each, alternating): "
          + json.dumps(out))
    return out


def _profile_train_step(torch, step, state, x_0, g, steps: int = 3):
    """Where a train step's time goes: the kernels' device time (the sum of
    every kernel's duration, torch.profiler) against the step's wall time,
    the operations with the most device and host time, and the operations
    that block the host (sync debug mode)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, x_0, g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    from torch.autograd import DeviceType

    avgs = prof.key_averages()
    # the device's own events (kernels, memsets, copies); an operator's
    # device time is the sum of its kernels', so counting both would count
    # each kernel twice
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top_device = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    top_ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                     key=lambda e: -e.device_time_total)[:12]
    top_host = sorted(avgs, key=lambda e: -e.self_cpu_time_total)[:12]
    syncs = host_syncs(torch, lambda: step(state, x_0, g))
    out = {
        "wall_ms_per_step": wall_ms,
        "kernel_ms_per_step": kernel_ms if kernel_ms > 0 else "not measured (no kernel in the trace)",
        "device_idle_share": 1.0 - kernel_ms / wall_ms if kernel_ms > 0 else "not measured",
        "top_kernels_ms_per_step": {e.key[:80]: e.self_device_time_total / 1e3 / steps for e in top_device},
        "top_operators_device_ms_per_step": {e.key[:80]: e.device_time_total / 1e3 / steps for e in top_ops},
        "top_host_ms_per_step": {e.key[:80]: e.self_cpu_time_total / 1e3 / steps for e in top_host},
        "host_syncs_per_step": syncs,
    }
    print(f"train step b{B} profile ({steps} steps, torch.profiler): " + json.dumps(out))
    return out


def phase_accum_cli(torch, tmp):
    """``python -m r2dm_tpu_torch.train`` with gradient accumulation at
    config H, b8: ACCUM_MICRO_STEPS micro-steps, then resumed for one more;
    the checkpoint holds optax MultiSteps' state mid-accumulation."""
    import numpy as np

    from r2dm_tpu_torch.checkpoint import load_checkpoint

    out = os.path.join(tmp, "train_accum")
    ckpt = os.path.join(out, "checkpoint.msgpack")
    argv = ["--data.dataset", "synthetic", "--training.output_dir", out, "--training.seed", "0",
            "--training.lr_warmup_steps", "1", "--training.gradient_accumulation_steps", str(ACCUM_STEPS),
            "--training.steps_save_image", "100000", "--training.steps_save_model", "100000"]
    saved_env = os.environ.get("R2DM_SYNTH_SCANS")
    os.environ["R2DM_SYNTH_SCANS"] = str(B)
    try:
        runs = [_train_cli(torch, argv + ["--training.num_steps", str(ACCUM_MICRO_STEPS)])]
        first = load_checkpoint(ckpt)
        runs.append(_train_cli(torch, argv + ["--training.num_steps", str(ACCUM_MICRO_STEPS + 1),
                                              "--training.resume", ckpt]))
        second = load_checkpoint(ckpt)
    finally:
        if saved_env is None:
            os.environ.pop("R2DM_SYNTH_SCANS")
        else:
            os.environ["R2DM_SYNTH_SCANS"] = saved_env
    for (seconds, launches), steps in zip(runs, (ACCUM_MICRO_STEPS, 1)):
        expected = launches_of(50 * steps, 96 * steps)
        print(f"python -m r2dm_tpu_torch.train, k={ACCUM_STEPS}, {steps} micro-steps b{B}: {seconds:.3f} s, "
              f"launches {json.dumps(launches)} (expected {json.dumps(expected)})")
        if launches != expected:
            raise AssertionError(f"accumulating train launches {launches} != {expected}")

    def counts(c):
        o = c["opt_state"]
        return (c["global_step"], int(o["mini_step"]), int(o["gradient_step"]),
                int(o["inner_opt_state"]["1"]["0"]["count"]), int(o["inner_opt_state"]["1"]["2"]["count"]))

    got = [counts(first), counts(second)]
    acc = [max(float(np.abs(a).max()) for a in _leaves(c["opt_state"]["acc_grads"])) for c in (first, second)]
    print(f"accumulation checkpoints: (step, mini_step, gradient_step, adam count, schedule count) {got}; "
          f"max |acc_grads| {acc}")
    if got != [(3, 1, 1, 1, 1), (4, 0, 2, 2, 2)] or not (acc[0] > 0 and acc[1] == 0):
        raise AssertionError(f"accumulation state {got}, running mean {acc}")
    leaves = _leaves(second["weights"]) + _leaves(second["opt_state"])
    if not all(np.isfinite(np.asarray(a)).all() for a in leaves):
        raise AssertionError("the accumulating run left non-finite weights or optimizer state")
    return {"seconds": [r[0] for r in runs], "launches_per_micro_step": {k: v // ACCUM_MICRO_STEPS
                                                                        for k, v in runs[0][1].items()}}


def phase_grad_bf16(torch, ddpm):
    """One config-H b8 train step with bf16 gradients through the kernel
    path and through the plain path (gradient relative L2, launch counts),
    then the step's time and peak memory beside the fp32-gradient step's."""
    import copy

    from r2dm_tpu_torch import config as config_lib
    from r2dm_tpu_torch import ops
    from r2dm_tpu_torch.models import layers
    from r2dm_tpu_torch.training import EMAConfig, init_train_state, make_optimizer, make_train_step

    model, diffusion = ddpm.model.train(), ddpm.diffusion
    g = torch.Generator("cuda").manual_seed(4)
    x_0 = torch.rand((B, 64, 1024, 2), generator=g, device="cuda") * 2 - 1
    steps = torch.rand((B,), generator=g, device="cuda")
    noise = torch.randn((B, 64, 1024, 2), generator=g, device="cuda")

    def trainer(grad_bf16: bool, lr: float):
        m = copy.deepcopy(model)
        cfg = config_lib.TrainingConfig(grad_bf16=grad_bf16, lr=lr, lr_warmup_steps=0)
        optimizer, scheduler = make_optimizer(m.parameters(), cfg)
        state = init_train_state(m, optimizer, scheduler)
        step = make_train_step(diffusion, optimizer, scheduler, EMAConfig(update_after_step=0, update_every=1),
                               grad_dtype=torch.bfloat16 if grad_bf16 else None)
        return state, step

    def grads():  # lr 0: the step's gradients, clipped, on the unchanged weights
        state, step = trainer(True, 0.0)
        ops.reset_launch_counts()
        metrics = step(state, x_0, steps=steps, noise=noise)
        torch.cuda.synchronize()
        flat = torch.cat([p.grad.flatten() for p in state.model.parameters()])
        return metrics, _launches(ops), flat

    metrics, launches, grad_k = grads()
    saved = {n: getattr(layers, n) for n in ("fused_group_norm_silu", "fused_act_ringconv")}
    try:
        layers.fused_group_norm_silu = ops.gn_silu.fused_group_norm_silu_plain
        layers.fused_act_ringconv = ops.act_ringconv.act_ringconv_plain
        metrics_p, _, grad_p = grads()
    finally:
        for n, fn in saved.items():
            setattr(layers, n, fn)
    rel_grad = ((grad_k - grad_p).norm() / grad_p.norm()).item()
    rel_loss = ((metrics["loss"] - metrics_p["loss"]).abs() / metrics_p["loss"].abs()).item()
    print(f"grad_bf16 step b{B}, kernel path vs plain path: loss {metrics['loss'].item():.6f} vs "
          f"{metrics_p['loss'].item():.6f} (relative {rel_loss:.3e}), gradient relative L2 {rel_grad:.3e} "
          f"(limit {TRAIN_REL_L2}); launches {json.dumps(launches)}")
    if launches != launches_of(50, 96):
        raise AssertionError(f"one grad_bf16 step launched {launches}, expected 50 GN and 96 conv")
    if not (math.isfinite(rel_grad) and rel_loss <= TRAIN_REL_L2 and rel_grad <= TRAIN_REL_L2):
        raise AssertionError(f"grad_bf16 kernel path vs plain path: loss {rel_loss}, gradient {rel_grad}")
    del grad_k, grad_p

    timing = {}
    for name, bf16 in (("fp32 gradients", False), ("bf16 gradients", True)):
        state, step = trainer(bf16, 1e-4)
        for _ in range(2):  # warm-up: AdamW's state, the allocator's pools
            step(state, x_0, steps=steps, noise=noise)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, x_0, steps=steps, noise=noise)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        timing[name] = {"median_step_ms": sorted(ms)[len(ms) // 2], "step_ms": ms,
                        "peak_bytes": torch.cuda.max_memory_allocated() - base}
        del state, step
    print(f"train step b{B} (CUDA events, 2 warm-up steps, 5 timed): " + json.dumps(timing))
    return {"rel_grad": rel_grad, "launches": launches, "timing": timing}


RANK_SCRIPT = r"""
import datetime, json, os, sys
import torch

rank, world, rendezvous, jobs = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], json.loads(sys.argv[4])
sys.modules["torch.utils.tensorboard"] = None  # the JSONL sink alone
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
torch.distributed.init_process_group("gloo", init_method="file://" + rendezvous, rank=rank, world_size=world,
                                     timeout=datetime.timedelta(seconds=90))
import chip_smoke  # on PYTHONPATH, the checkout's root

results = []
for job in jobs:  # each module's main (or a function of this script) in turn, in its working directory
    os.chdir(job["cwd"])
    os.environ.update(job["env"])
    if "call" in job:
        results.append(getattr(chip_smoke, job["call"])(torch, **job["kwargs"]))
    else:
        results.append(chip_smoke.counted_main(torch, job["module"], job["argv"]))
torch.distributed.destroy_process_group()
print("RANK_RESULT " + json.dumps(results), flush=True)
"""


def counted_main(torch, module: str, argv: list) -> dict:
    """``module``'s main on ``argv`` in this process with the launch counters
    zeroed before and read after; the train module's loss of each step is
    recorded (this rank's rows). A sample_and_save with no width axis
    replays its forwards' CUDA graph, so its launches are the kernels that
    ran on the card (``device_launches``)."""
    import importlib

    from r2dm_tpu_torch import ops

    mod = importlib.import_module(module)
    losses = []
    saved = getattr(mod, "make_train_step", None)
    if module.endswith(".train"):
        def recording(*args, **kwargs):
            step = saved(*args, **kwargs)

            def counted(*a, **k):
                out = step(*a, **k)
                losses.append(float(out["loss"]))
                return out

            return counted

        mod.make_train_step = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ran = device_launches(torch) if module.endswith(".sample_and_save") and "--mesh" not in argv else None
    t0 = time.time()
    try:
        if ran is not None:
            ran.__enter__()
        rc = mod.main(argv) if module.endswith(".train") else mod.main(mod.parse_args(argv))
        torch.cuda.synchronize()
    finally:
        if ran is not None:
            ran.stop()
        if saved is not None:
            mod.make_train_step = saved
    return {"module": module, "rc": rc, "seconds": time.time() - t0, "losses": losses,
            "peak_bytes": torch.cuda.max_memory_allocated(), "launches": ran.counts if ran else _launches(ops)}


def _two_ranks(work: str, jobs_by_rank: list) -> list:
    """Rank r's ``jobs_by_rank[r]`` ({module, argv, cwd, env} each, run in
    turn) in two processes on this card, each calling init_process_group("gloo") with
    RANK, WORLD_SIZE=2 and LOCAL_RANK=0 and then each module's main; every
    rank's list of ``counted_main`` results. Raises when a rank fails or
    the pair passes RANK_TIMEOUT_S (both are then killed)."""
    run_dir = os.path.join(work, "ranks")
    os.makedirs(run_dir)
    script = os.path.join(run_dir, "rank.py")
    with open(script, "w") as f:
        f.write(RANK_SCRIPT)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo}
    logs = [os.path.join(run_dir, f"rank{r}.log") for r in range(2)]
    procs = []
    for r in range(2):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, script, str(r), "2", os.path.join(run_dir, "rendezvous"), json.dumps(jobs_by_rank[r])],
                cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.time() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for path in logs:
        with open(path) as f:
            outs.append(f.read())
    if hung:
        raise AssertionError(f"ranks {hung} passed the {RANK_TIMEOUT_S} s deadline:\n"
                             + "\n".join(o[-2000:] for o in outs))
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("RANK_RESULT ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{out[-4000:]}")
        results.append(json.loads(lines[-1][len("RANK_RESULT "):]))
    return results


def phase_two_ranks(torch, tmp, eval_out, card):
    """The data axis as two gloo ranks sharing this card (a correctness
    check: they compete for one card, so their times are no scaling
    number), each path against one rank; then one rank under NCCL."""
    import socket

    import numpy as np

    from r2dm_tpu_torch import config as config_lib
    from r2dm_tpu_torch.checkpoint import load_checkpoint
    from r2dm_tpu_torch.inference import build_model
    from r2dm_tpu_torch.utils.weights import jax_from_state_dict

    work = os.path.join(tmp, "data_axis")
    os.makedirs(work)
    steps = 4
    out = {"card": card}

    def train_argv(out_dir, n):
        return ["--data.dataset", "synthetic", "--training.output_dir", out_dir, "--training.seed", "0",
                "--training.num_steps", str(n), "--training.lr_warmup_steps", "1",
                "--training.steps_save_image", "100000", "--training.steps_save_model", "100000"]

    # one rank in this process: the trainer for 4 steps at b8, then under
    # NCCL (torchrun's environment for one rank) for 2
    one_dir, two_dir, nccl_dir = (os.path.join(work, d) for d in ("train1", "train2", "train_nccl"))
    saved_env = {k: os.environ.get(k) for k in ("R2DM_SYNTH_SCANS", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                                                "MASTER_ADDR", "MASTER_PORT")}
    try:
        os.environ["R2DM_SYNTH_SCANS"] = str(B)
        one = counted_main(torch, "r2dm_tpu_torch.train", train_argv(one_dir, steps))
        with socket.socket() as sock:  # a free port on this machine for the rendezvous
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        nccl = counted_main(torch, "r2dm_tpu_torch.train", train_argv(nccl_dir, 2))
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # two ranks: the trainer (global b8, b4 a rank), sample_and_save (phase
    # 9's 16 samples, the seeds strided) and evaluate (phase 9's JSON, the
    # extraction split), each rank with its own working directory for the
    # real-set cache
    samples = os.path.join(work, "samples")
    cwds = [os.path.join(work, f"rank{r}") for r in range(2)]
    for d in cwds:
        os.makedirs(d)
    json_dir = os.path.dirname(eval_out["samples"])
    before = set(os.listdir(json_dir))
    jobs = [
        {"module": "r2dm_tpu_torch.train", "argv": train_argv(two_dir, steps), "env": {"R2DM_SYNTH_SCANS": str(B)}},
        {"module": "r2dm_tpu_torch.sample_and_save", "env": {},
         "argv": ["--ckpt", eval_out["ckpt"], "--output_dir", samples, "--batch_size", str(B), "--num_samples",
                  str(2 * B), "--num_steps", "4", "--mode", "ddim"]},
        {"module": "r2dm_tpu_torch.evaluate", "env": {"R2DM_SYNTH_SCANS": str(2 * B)},
         "argv": ["--ckpt", eval_out["ckpt"], "--sample_dir", eval_out["samples"], "--batch_size", str(B),
                  "--rangenet_tar", eval_out["tar"], "--pointnet_ckpt", eval_out["pth"]]},
    ]
    t0 = time.time()
    ranks = _two_ranks(work, [[{**job, "cwd": cwds[r]} for job in jobs] for r in range(2)])
    seconds = time.time() - t0
    train2, sample2, eval2 = ([rank[i] for rank in ranks] for i in range(3))

    # ---- the trainer
    expected = launches_of(50 * steps, 96 * steps)
    launches = [r["launches"] for r in train2]
    if one["launches"] != expected or launches != [expected, expected]:
        raise AssertionError(f"train launches: one rank {one['launches']}, two ranks {launches}; each {expected}")
    global_loss = [(a + b) / 2 for a, b in zip(train2[0]["losses"], train2[1]["losses"])]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(global_loss, one["losses"])]
    with torch.random.fork_rng(devices=[]):  # the trainer's initial weights, from its seed
        torch.manual_seed(0)
        w0 = jax_from_state_dict(build_model(config_lib.Config(), dtype=torch.bfloat16, device="cpu").state_dict())
    w = [load_checkpoint(os.path.join(d, "checkpoint.msgpack"))["weights"] for d in (one_dir, two_dir)]
    start, w1, w2 = (np.concatenate([np.asarray(a, np.float64).ravel() for a in _leaves(t["params"])])
                     for t in (w0, w[0], w[1]))
    upd_rel = float(np.linalg.norm(w2 - w1) / np.linalg.norm(w1 - start))
    out["train"] = {"one_rank_loss": one["losses"], "two_rank_loss": global_loss, "loss_rel": loss_rel,
                    "update_rel_l2": upd_rel, "max_abs_weight_diff": float(np.abs(w2 - w1).max()),
                    "launches_per_rank_per_step": {k: v // steps for k, v in launches[0].items()},
                    "seconds": [one["seconds"], train2[0]["seconds"]],
                    "peak_bytes": [one["peak_bytes"], train2[0]["peak_bytes"]]}
    print(f"two ranks on one card, train {steps} steps at global b{B} (b{B // 2} a rank) against one rank "
          f"({card}; ranks share the card: a correctness check, no scaling number): {json.dumps(out['train'])}")
    if not (len(global_loss) == steps and max(loss_rel) <= TWO_RANK_LOSS_REL and upd_rel <= TWO_RANK_UPDATE_REL):
        raise AssertionError(f"two ranks against one: loss {loss_rel} (limit {TWO_RANK_LOSS_REL}), "
                             f"update {upd_rel} (limit {TWO_RANK_UPDATE_REL})")

    # ---- sample_and_save
    files = sorted(os.listdir(samples))
    gaps = [float(np.abs(np.load(os.path.join(samples, f))["sample"]
                         - np.load(os.path.join(eval_out["samples"], f))["sample"]).max()) for f in files]
    expected = launches_of(50 * 4, 48 * 4)  # 8 seeds a rank, 4 steps, one batch
    out["sample_and_save"] = {"files": len(files), "max_abs_diff_vs_one_rank": max(gaps),
                              "launches": [r["launches"] for r in sample2], "seconds": sample2[0]["seconds"]}
    print(f"two ranks, sample_and_save {2 * B} samples ({card}): {json.dumps(out['sample_and_save'])}")
    if files != sorted(os.listdir(eval_out["samples"])) or [r["launches"] for r in sample2] != [expected] * 2 \
            or not max(gaps) <= TWO_RANK_SAMPLE_ATOL:
        raise AssertionError(f"two-rank sample_and_save: {out['sample_and_save']} (limit {TWO_RANK_SAMPLE_ATOL})")

    # ---- evaluate
    [new] = [f for f in set(os.listdir(json_dir)) - before if f.endswith(".json")]
    with open(os.path.join(json_dir, new)) as f:
        got = json.load(f)
    ref = eval_out["json"]
    gap = max(abs(got[s][k] - v) / max(abs(v), 1e-30) for s in ("img", "pts", "bev") for k, v in ref[s].items())
    caches = [[f for f in os.listdir(d) if f.startswith("real_set_")] for d in cwds]
    out["evaluate"] = {"max_rel_diff_vs_one_rank": gap, "info": got["info"], "caches_by_rank": caches,
                       "seconds": eval2[0]["seconds"]}
    print(f"two ranks, evaluate ({card}): {json.dumps(out['evaluate'])}")
    if not (gap <= 1e-6 and got["info"] == ref["info"] and len(caches[0]) == 1 and not caches[1]
            and eval2[0]["launches"] == eval2[1]["launches"] == launches_of(0, 0)):
        raise AssertionError(f"two-rank evaluate: {out['evaluate']}")

    # ---- one rank under NCCL
    expected = launches_of(50 * 2, 96 * 2)
    ck = load_checkpoint(os.path.join(nccl_dir, "checkpoint.msgpack"))
    gap = max(abs(a - b) / abs(b) for a, b in zip(nccl["losses"], one["losses"]))
    out["nccl"] = {"launches": nccl["launches"], "losses": nccl["losses"], "loss_rel_vs_one_rank": gap,
                   "step": ck["global_step"], "seconds": nccl["seconds"]}
    print(f"one rank under NCCL, train 2 steps b{B} ({card}): {json.dumps(out['nccl'])}")
    if nccl["launches"] != expected or ck["global_step"] != 2 or len(nccl["losses"]) != 2 or not gap <= 1e-6:
        raise AssertionError(f"NCCL one-rank train: {out['nccl']}, expected {expected} and the one-rank losses")
    out["two_rank_seconds"] = seconds
    return out


def _trace_collectives(world) -> None:
    """Zero the world's count of width collectives and trace them from here
    (``r2dm_tpu_torch/utils/trace.py``)."""
    from r2dm_tpu_torch.utils import trace

    world.collective_calls = 0
    trace.reset()
    trace.enable()


def _collectives(world) -> tuple:
    """The width collectives since ``_trace_collectives``: their count and
    the host seconds of their ``parallel.collective`` spans; tracing off."""
    from r2dm_tpu_torch.utils import trace

    seconds = trace.total(trace.snapshot(), "parallel.collective")
    trace.disable()
    return world.collective_calls, seconds


def _rel(a, b) -> float:
    """Relative L2 of a against b, in float64."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def _plain_layers():
    """A context in which the network runs the plain versions of its
    kernels (the patch phase_main applies for its kernel-vs-plain check):
    GroupNorm, the ring conv and, on the int8 lane, the quantized conv."""
    import contextlib

    from r2dm_tpu_torch import ops
    from r2dm_tpu_torch.models import layers

    def plain_w8a8(x, kernel, bias, out_dtype=None, packed=None, width=None):
        return ops.quant.ring_conv_w8a8_plain(x, kernel, bias, out_dtype)

    @contextlib.contextmanager
    def patched():
        saved = (layers.fused_group_norm_silu, layers.fused_act_ringconv, layers.ring_conv_w8a8)
        layers.fused_group_norm_silu = ops.gn_silu.fused_group_norm_silu_plain
        layers.fused_act_ringconv = ops.act_ringconv.act_ringconv_plain
        layers.ring_conv_w8a8 = plain_w8a8
        try:
            yield
        finally:
            layers.fused_group_norm_silu, layers.fused_act_ringconv, layers.ring_conv_w8a8 = saved

    return patched()


def width_rank_job(torch, ckpt: str, chain_out: str) -> dict:
    """One rank of the width phase (``--mesh 1x2``): one b8 network forward
    sharded against this rank's unsharded forward, with its launches and
    the width collectives' host time; one rank's DDIM-4 chain and each of
    its steps again sharded from the same x_t (forward and step output);
    then the sharded DDIM-4 chain through ``DDPM.sample(world=)`` with its
    launches (the width axis's main path), written to ``chain_out`` by
    width rank 0."""
    import numpy as np

    from r2dm_tpu_torch import ops, parallel, setup_model
    from r2dm_tpu_torch.models import layers

    world = parallel.init("cuda", mesh=WIDTH_MESH)
    out = {"rank": world.rank, "width_rank": world.width_rank, "width_size": world.width_size}
    try:
        ddpm, _, _ = setup_model(ckpt, dtype=torch.bfloat16, device=world.device)
        model, diff = ddpm.model, ddpm.diffusion
        x = randn(torch, (B, 64, 1024, 2), 40)
        cond = torch.linspace(-5.0, 5.0, B, device="cuda")
        with torch.inference_mode():
            ref = model(x, cond)
            xs = parallel.shard_columns(x, world)
            with layers.width_sharded(model, world):
                model(xs, cond)  # warm-up
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                _trace_collectives(world)
                t0 = time.time()
                y = model(xs, cond)
                torch.cuda.synchronize()
                out["forward_host_s"] = time.time() - t0
                out["forward_launches"] = _launches(ops)
                out["collective_calls"], out["collective_host_s"] = _collectives(world)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                model(xs, cond)
                end.record()
                torch.cuda.synchronize()
                out["forward_event_ms"] = start.elapsed_time(end)
            out["forward_rel_l2"] = _rel(parallel.gather_columns(y, world), ref)

            steps, seeds = WIDTH_DDIM_STEPS, list(range(B))
            one = ddpm.sample(B, steps, mode="ddim", seeds=seeds, data_format="NHWC", return_all=True)
            ts = torch.linspace(1.0, 0.0, steps + 1, dtype=torch.float32, device="cuda")
            out["teacher_forced_forward_rel_l2"], out["teacher_forced_step_rel_l2"] = [], []
            for i in range(steps):
                x_t = one[i]
                logsnr = diff._steps(ts[i], B, x_t.device)
                ref = model(x_t, logsnr)
                with layers.width_sharded(model, world):
                    y = parallel.gather_columns(model(parallel.shard_columns(x_t, world), logsnr), world)
                    x_s = parallel.gather_columns(diff.p_step(parallel.shard_columns(x_t, world), ts[i], ts[i + 1],
                                                              mode="ddim"), world)
                out["teacher_forced_forward_rel_l2"].append(_rel(y, ref))
                out["teacher_forced_step_rel_l2"].append(_rel(x_s, one[i + 1]))

            torch.cuda.synchronize()
            ops.reset_launch_counts()
            two = ddpm.sample(B, steps, mode="ddim", seeds=seeds, data_format="NHWC", world=world)
            torch.cuda.synchronize()
            out["ddim_launches"] = _launches(ops)
            out["ddim_rel_l2_vs_this_rank"] = _rel(two, one[-1])
            if world.width_rank == 0:
                np.save(chain_out, two.float().cpu().numpy())
    finally:
        world.close()
    return out


def width_int8_job(torch, ckpt: str, chain_out: str) -> dict:
    """One rank of the width phase's int8 lane (``--mesh 1x2``): every site
    of one b8 forward on one rank (its input recorded there) fed this rank's
    columns, the s8 layout, the absmax and the output against one rank's,
    bit for bit; a NaN in the other rank's columns; one sharded b8 forward
    against this rank's unsharded one, with its launches and the
    collectives' host time; then a DDIM-4 chain through
    ``DDPM.sample(world=)`` with its launches (the lane's main path under
    the width axis), written to ``chain_out`` by width rank 0."""
    import numpy as np

    from r2dm_tpu_torch import ops, parallel, setup_model
    from r2dm_tpu_torch.models import layers
    from r2dm_tpu_torch.ops import quant

    world = parallel.init("cuda", mesh=WIDTH_MESH)
    out = {"rank": world.rank, "width_rank": world.width_rank}
    try:
        ddpm, _, _ = setup_model(ckpt, dtype=torch.bfloat16, device=world.device)
        model = layers.set_quant_conv(ddpm.model, "w8a8")
        x = randn(torch, (B, 64, 1024, 2), 40)
        cond = torch.linspace(-5.0, 5.0, B, device="cuda")
        sites, real = [], layers.ring_conv_w8a8

        def recorded(x, kernel, bias, out_dtype=None, packed=None, width=None):
            sites.append((x, kernel, bias, out_dtype or x.dtype))
            return real(x, kernel, bias, out_dtype, packed, width=width)

        with torch.inference_mode():
            layers.ring_conv_w8a8 = recorded
            try:  # the eager body: a graphed forward's first call runs its Python twice
                ref = model._forward(x, cond)
            finally:
                layers.ring_conv_w8a8 = real
            exact = []
            for x_site, k, b, od in sites:
                xs = parallel.shard_columns(x_site, world)
                Wl = xs.shape[2]
                amax = quant.act_absmax(xs, world)
                xq = quant.act_quantize(xs, amax, halo=parallel.halo_exchange(xs, 1, 1, world))
                one_amax = quant.act_absmax(x_site)
                one_xq = quant.act_quantize(x_site, one_amax).narrow(2, world.width_rank * Wl, Wl + 2)
                packed = quant.pack_weight(k)
                y = parallel.gather_columns(quant.ring_conv_w8a8(xs, k, b, od, packed, width=world), world)
                exact.append(bool(torch.equal(amax, one_amax) and torch.equal(xq, one_xq)
                                  and torch.equal(y, quant.ring_conv_w8a8(x_site, k, b, od, packed))))
            out["sites"], out["sites_bit_for_bit"] = len(sites), sum(exact)
            x_nan, k, b, od = sites[1]
            x_nan = x_nan.clone()
            x_nan[B - 1, 5, x_nan.shape[2] - 3, 0] = float("nan")  # in width rank 1's columns
            y = quant.ring_conv_w8a8(parallel.shard_columns(x_nan, world), k, b, od, width=world)
            out["nan_all"] = bool(torch.isnan(y).all())
            del sites, x_nan, y
            with layers.width_sharded(model, world):
                xs = parallel.shard_columns(x, world)
                model(xs, cond)  # warm-up
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                _trace_collectives(world)
                t0 = time.time()
                y = model(xs, cond)
                torch.cuda.synchronize()
                out["forward_host_s"] = time.time() - t0
                out["forward_launches"] = _launches(ops)
                out["collective_calls"], out["collective_host_s"] = _collectives(world)
            out["forward_rel_l2"] = _rel(parallel.gather_columns(y, world), ref)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            two = ddpm.sample(B, WIDTH_DDIM_STEPS, mode="ddim", seeds=list(range(B)), data_format="NHWC",
                              world=world)
            torch.cuda.synchronize()
            out["ddim_launches"] = _launches(ops)
            if world.width_rank == 0:
                np.save(chain_out, two.float().cpu().numpy())
    finally:
        world.close()
    return out


def width_train_job(torch) -> dict:
    """One rank of the width training phase (``--mesh 1x2``): width rank 0
    first takes one config-H b8 loss + backward on the whole image through
    the kernel path and through the plain path (phase 8's weights, batch,
    steps and noise), the yardstick; then both ranks take the same step on
    their columns, the gradients summed over the world as the trainer sums
    them, with its launches, the collectives' calls and host seconds, and
    (width rank 0) its distance from the one-rank kernel path."""
    from r2dm_tpu_torch import ops, parallel
    from r2dm_tpu_torch.bench import random_ddpm
    from r2dm_tpu_torch.models import layers

    world = parallel.init("cuda", mesh=WIDTH_MESH)
    out = {"rank": world.rank, "width_rank": world.width_rank}
    try:
        ddpm = random_ddpm(seed=1)
        model, diffusion = ddpm.model.train(), ddpm.diffusion
        g = torch.Generator("cuda").manual_seed(2)
        x_0 = torch.rand((B, 64, 1024, 2), generator=g, device="cuda") * 2 - 1
        steps = torch.rand((B,), generator=g, device="cuda")
        noise = torch.randn((B, 64, 1024, 2), generator=g, device="cuda")

        def loss_and_grad(x_0, noise):
            model.zero_grad(set_to_none=True)
            loss = diffusion.p_loss(model, x_0, steps, noise)
            loss.backward()
            return loss.detach(), torch.cat([p.grad.flatten() for p in model.parameters()])

        if world.width_rank == 0:
            loss_k, grad_k = loss_and_grad(x_0, noise)
            with _plain_layers():
                loss_p, grad_p = loss_and_grad(x_0, noise)
            out["kernel_vs_plain_loss_rel"] = ((loss_k - loss_p).abs() / loss_p.abs()).item()
            out["kernel_vs_plain_grad_rel_l2"] = _rel(grad_k, grad_p)
            del grad_p
        layers.set_width_shard(model, world)
        xs, ns = parallel.shard_columns(x_0, world), parallel.shard_columns(noise, world)
        loss_and_grad(xs, ns)  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        _trace_collectives(world)
        t0 = time.time()
        loss_s, grad_s = loss_and_grad(xs, ns)
        torch.cuda.synchronize()
        out["step_host_s"] = time.time() - t0
        out["launches"] = _launches(ops)
        out["collective_calls"], out["collective_host_s"] = _collectives(world)
        for t in (loss_s, grad_s):  # the width shares summed (D = 1), as training/step.py sums them
            torch.distributed.all_reduce(t)
        if world.width_rank == 0:
            out["loss"], out["one_rank_loss"] = loss_s.item(), loss_k.item()
            out["loss_rel"] = ((loss_s - loss_k).abs() / loss_k.abs()).item()
            out["grad_rel_l2"] = _rel(grad_s, grad_k)
    finally:
        world.close()
    return out


def width_bench_job(torch) -> dict:
    """``r2dm_tpu_torch.bench --mesh 1x2 --batch 8 --steps 2`` on this rank
    (its line printed by rank 0); the aggregated result."""
    from r2dm_tpu_torch import bench

    return bench.main(batch=B, steps=2, trials=1, ddim_steps=2, mesh=WIDTH_MESH)


def phase_validate(torch, main_out, eval_out, card):
    """``python -m r2dm_tpu_torch.validate_pretrained`` on phase 4's
    r2dm-h-random.pth with phase 9's random extractor files (``--skip_
    reference`` unless $R2DM_REFERENCE_DIR names the original PyTorch
    code): rc 0, every stage ok, and exact launches (its sample stage, 8
    DDPM steps at b2: 50 GN + 48 conv a forward, read from the kernels that
    ran on the card)."""

    reference = os.environ.get("R2DM_REFERENCE_DIR")
    argv = [main_out["ckpt"], "--json", "--rangenet_tar", eval_out["tar"], "--pointnet_ckpt", eval_out["pth"]]
    argv += ["--reference_dir", reference] if reference else ["--skip_reference"]
    with device_launches(torch) as ran:
        t0 = time.time()
        printed = _run_cli("r2dm_tpu_torch.validate_pretrained", argv)  # raises unless it exits 0
        torch.cuda.synchronize()
        seconds = time.time() - t0
    out = {"seconds": seconds, "launches": ran.counts, "report": json.loads(printed.strip().splitlines()[-1])}
    print(f"python -m r2dm_tpu_torch.validate_pretrained {' '.join(os.path.basename(a) for a in argv)} ({card}): "
          f"{json.dumps(out)}")
    expected = launches_of(50 * 8, 48 * 8)
    stages = out["report"]["stages"]
    if not (out["report"]["ok"] and list(stages) == ["import", "ref-parity", "sample", "metrics"]
            and all(v["ok"] for v in stages.values()) and out["launches"] == expected):
        raise AssertionError(f"validate_pretrained: {out} (launches {expected})")
    return out


def _refinenet(torch, dtype=None):
    """(cfg, the RefineNet at REFINENET_FLAGS's width on the card): phase
    15's random weights (build_model from torch seed 0), computing in
    ``dtype``."""
    from r2dm_tpu_torch import config as config_lib
    from r2dm_tpu_torch.inference import build_model

    cfg = config_lib.Config(model=config_lib.ModelConfig(architecture="refinenet", base_channels=128,
                                                         channel_multiplier=(1, 2, 2, 2)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return cfg, build_model(cfg, dtype=dtype, device="cpu").to("cuda")


def width_refinenet_job(torch) -> dict:
    """One rank of phase 16's RefineNet under ``--mesh 1x2``: a b8 forward
    in fp32 (TF32 off) and in bf16 on this rank's columns against this
    rank's whole-image forward, with its collectives and their host
    seconds; one rank's DDIM-4 chain in bf16 and in fp32 (the yardstick)
    and the bf16 chain through ``DDPM.sample(world=)``; the hand-written
    kernels' launches over the job (none: plain PyTorch and cuDNN)."""
    from r2dm_tpu_torch import ops, parallel
    from r2dm_tpu_torch.inference import DDPM, build_diffusion
    from r2dm_tpu_torch.models import layers

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    world = parallel.init("cuda", mesh=WIDTH_MESH)
    out = {"rank": world.rank, "width_rank": world.width_rank}
    ddpms = {}
    try:
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        x = randn(torch, (B, 64, 1024, 2), 40)
        cond = torch.linspace(0.0, 1.0, B, device="cuda")
        xs = parallel.shard_columns(x, world)
        refs = {}
        for tag, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
            cfg, net = _refinenet(torch, dtype)
            ddpms[tag] = DDPM(build_diffusion(cfg, net), cfg)
            with torch.inference_mode():
                ref = refs[tag] = net(x, cond)
                with layers.width_sharded(net, world):
                    net(xs, cond)  # warm-up
                    torch.cuda.synchronize()
                    _trace_collectives(world)
                    t0 = time.time()
                    y = net(xs, cond)
                    torch.cuda.synchronize()
                    host_s = time.time() - t0
                    calls, coll_s = _collectives(world)
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    net(xs, cond)
                    end.record()
                    torch.cuda.synchronize()
                out[f"forward_{tag}"] = {"rel_l2": _rel(parallel.gather_columns(y, world), ref), "host_s": host_s,
                                         "event_ms": start.elapsed_time(end), "collective_calls": calls,
                                         "collective_host_s": coll_s}
        out["forward_bf16"]["bf16_vs_fp32_rel_l2"] = _rel(refs["bf16"], refs["fp32"])
        seeds = list(range(B))
        with torch.inference_mode():
            one = {tag: d.sample(B, WIDTH_DDIM_STEPS, mode="ddim", seeds=seeds, data_format="NHWC")
                   for tag, d in ddpms.items()}
            t0 = time.time()
            two = ddpms["bf16"].sample(B, WIDTH_DDIM_STEPS, mode="ddim", seeds=seeds, data_format="NHWC", world=world)
            torch.cuda.synchronize()
        out["ddim"] = {"rel_l2_vs_one_rank": _rel(two, one["bf16"]), "bf16_vs_fp32_rel_l2": _rel(one["bf16"], one["fp32"]),
                       "seconds": time.time() - t0, "finite": bool(torch.isfinite(two).all())}
        out["launches"] = _launches(ops)
    finally:
        world.close()
        ddpms.clear()
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def width_refinenet_train_job(torch) -> dict:
    """One rank of the width training phase's RefineNet under ``--mesh
    1x2``: width rank 0 first takes one b8 bf16 loss + backward on the whole
    image (the trainer's mixed precision); then both ranks take it on their
    columns, the gradients summed over the world as the trainer sums them,
    with the collectives' calls and host seconds, the peak memory and the
    hand-written kernels' launches (none)."""
    from r2dm_tpu_torch import ops, parallel
    from r2dm_tpu_torch.diffusion import ContinuousTimeGaussianDiffusion
    from r2dm_tpu_torch.models import layers

    world = parallel.init("cuda", mesh=WIDTH_MESH)
    out = {"rank": world.rank, "width_rank": world.width_rank}
    try:
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        _, model = _refinenet(torch, torch.bfloat16)
        diffusion = ContinuousTimeGaussianDiffusion(model.train())
        g = torch.Generator("cuda").manual_seed(2)
        x_0 = torch.rand((B, 64, 1024, 2), generator=g, device="cuda") * 2 - 1
        steps = torch.rand((B,), generator=g, device="cuda")
        noise = torch.randn((B, 64, 1024, 2), generator=g, device="cuda")

        def loss_and_grad(x_0, noise):
            model.zero_grad(set_to_none=True)
            loss = diffusion.p_loss(model, x_0, steps, noise)
            loss.backward()
            return loss.detach(), torch.cat([p.grad.flatten() for p in model.parameters()])

        if world.width_rank == 0:
            loss_1, grad_1 = loss_and_grad(x_0, noise)
            torch.cuda.empty_cache()
        layers.set_width_shard(model, world)
        xs, ns = parallel.shard_columns(x_0, world), parallel.shard_columns(noise, world)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _trace_collectives(world)
        t0 = time.time()
        loss_s, grad_s = loss_and_grad(xs, ns)
        torch.cuda.synchronize()
        out["step_host_s"] = time.time() - t0
        out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        out["collective_calls"], out["collective_host_s"] = _collectives(world)
        for t in (loss_s, grad_s):  # the width shares summed (D = 1), as training/step.py sums them
            torch.distributed.all_reduce(t)
        if world.width_rank == 0:
            out["loss"], out["one_rank_loss"] = loss_s.item(), loss_1.item()
            out["loss_rel"] = ((loss_s - loss_1).abs() / loss_1.abs()).item()
            out["grad_rel_l2"] = _rel(grad_s, grad_1)
        out["launches"] = _launches(ops)
    finally:
        world.close()
        torch.cuda.empty_cache()
    return out


def _width_refinenet_checks(r0, r1, card) -> dict:
    """Phase 16's RefineNet gates on both ranks' ``width_refinenet_job``:
    the fp32 forward within REFINENET_WIDTH_FP32_REL_L2 of one rank, the
    bf16 forward and the DDIM-4 chain within WIDTH_SPREAD times one rank's
    bf16-vs-fp32 distance on the same input (the RefineNet's decoder has no
    norm, so a bf16 rounding of its convs moves the forward by more than
    the EfficientUNet's WIDTH_FORWARD_REL_L2: 1.15e-2 against one rank on
    an NVIDIA H100 80GB HBM3 at 700 W), REFINENET_WIDTH_COLLECTIVES a
    forward, no hand-written launch."""
    out = {k: r0[k] for k in ("forward_fp32", "forward_bf16", "ddim")}
    out["launches_per_rank"] = [r0["launches"], r1["launches"]]
    print(f"width axis {WIDTH_MESH}, the RefineNet (base 128, (1, 2, 2, 2)) b{B}, two gloo ranks on one card "
          f"({card}; a correctness check, no scaling number): {json.dumps(out)}")
    failures = []
    bf16_limit = WIDTH_SPREAD * r0["forward_bf16"]["bf16_vs_fp32_rel_l2"]
    for tag, limit in (("fp32", REFINENET_WIDTH_FP32_REL_L2), ("bf16", bf16_limit)):
        for r in (r0, r1):
            fwd = r[f"forward_{tag}"]
            if not (math.isfinite(fwd["rel_l2"]) and fwd["rel_l2"] <= limit):
                failures.append(f"{tag} forward on rank {r['rank']}: {fwd['rel_l2']} against one rank, limit {limit}")
            if fwd["collective_calls"] != REFINENET_WIDTH_COLLECTIVES:
                failures.append(f"{tag} forward on rank {r['rank']}: {fwd['collective_calls']} collectives, "
                                f"expected {REFINENET_WIDTH_COLLECTIVES}")
    ddim = out["ddim"]
    if not (ddim["finite"] and ddim["rel_l2_vs_one_rank"] <= WIDTH_SPREAD * ddim["bf16_vs_fp32_rel_l2"]):
        failures.append(f"DDIM-{WIDTH_DDIM_STEPS}: {ddim} (limit {WIDTH_SPREAD} x the bf16-vs-fp32 distance)")
    if out["launches_per_rank"] != [launches_of(0, 0)] * 2:
        failures.append(f"hand-written launches {out['launches_per_rank']}, expected none")
    if failures:
        raise AssertionError("the RefineNet under the width axis: " + "; ".join(failures))
    out["launches"] = r0["launches"]
    return out


def phase_width(torch, main_out, eval_out, tmp, card):
    """The width axis: two gloo ranks sharing this card with ``--mesh 1x2``
    (a correctness check, no scaling number), each holding 512 of the 1024
    columns: a forward and a DDIM-4 chain against one rank, exact launches
    (48 halo'd convs, 50 + 50 GN stats/apply a forward and a rank, no
    ring-form conv or one-launch GN), ``sample_and_save`` on phase 9's
    seeds against phase 9's files, and ``bench --mesh 1x2``."""
    import numpy as np

    from r2dm_tpu_torch import setup_model
    from r2dm_tpu_torch.sample_and_save import postprocess

    work = os.path.join(tmp, "width_axis")
    os.makedirs(work)
    chain_out, int8_chain_out = (os.path.join(work, f"ddim_two_ranks{t}.npy") for t in ("", "_int8"))
    samples, int8_samples = os.path.join(work, "samples"), os.path.join(work, "samples_int8")
    int8_sas_argv = ["--ckpt", main_out["ckpt"], "--num_samples", str(B), "--batch_size", str(B), "--num_steps", "2",
                     "--mode", "ddim"]
    # the int8 jobs last: R2DM_TPU_INT8 stays set in the ranks from then on
    jobs = [
        {"call": "width_rank_job", "kwargs": {"ckpt": main_out["ckpt"], "chain_out": chain_out}, "env": {}},
        {"module": "r2dm_tpu_torch.sample_and_save", "env": {},
         "argv": ["--ckpt", eval_out["ckpt"], "--output_dir", samples, "--batch_size", str(B), "--num_samples",
                  str(2 * B), "--num_steps", "4", "--mode", "ddim", "--mesh", WIDTH_MESH]},
        {"call": "width_bench_job", "kwargs": {}, "env": {"R2DM_BENCH_BUDGET_S": "300"}},
        {"call": "width_refinenet_job", "kwargs": {}, "env": {}},
        {"call": "width_int8_job", "kwargs": {"ckpt": main_out["ckpt"], "chain_out": int8_chain_out}, "env": {}},
        {"module": "r2dm_tpu_torch.sample_and_save", "env": {"R2DM_TPU_INT8": "1"},
         "argv": int8_sas_argv + ["--output_dir", int8_samples, "--mesh", WIDTH_MESH]},
        {"call": "width_bench_job", "kwargs": {}, "env": {}},
    ]
    t0 = time.time()
    ranks = _two_ranks(work, [[{**job, "cwd": work} for job in jobs] for _ in range(2)])
    seconds = time.time() - t0
    (job0, job1), (sas0, sas1), (bench0, _), (rn0, rn1), (i8_0, i8_1), (i8sas0, i8sas1), (i8bench0, _) = (
        [rank[i] for rank in ranks] for i in range(7))
    out = {"card": card, "seconds": seconds}

    # ---- one forward, and the chain's steps fed one rank's x_t
    per_forward = launches_of(0, 0, halo=48, gn_pair=50)
    fwd = {k: job0[k] for k in ("forward_rel_l2", "forward_host_s", "forward_event_ms", "collective_calls",
                                "collective_host_s", "teacher_forced_forward_rel_l2", "teacher_forced_step_rel_l2",
                                "ddim_rel_l2_vs_this_rank")}
    fwd["launches_per_rank"] = [job0["forward_launches"], job1["forward_launches"]]
    out["forward"] = fwd
    print(f"width axis {WIDTH_MESH}, two gloo ranks on one card ({card}; a correctness check, no scaling number): "
          f"b{B} forward and DDIM-{WIDTH_DDIM_STEPS} steps fed one rank's x_t: {json.dumps(fwd)}")
    rels = [job0["forward_rel_l2"]] + job0["teacher_forced_forward_rel_l2"]
    if not all(math.isfinite(r) and r <= WIDTH_FORWARD_REL_L2 for r in rels):
        raise AssertionError(f"sharded forward against one rank: relative L2 {rels} (limit {WIDTH_FORWARD_REL_L2})")
    if fwd["launches_per_rank"] != [per_forward] * 2:
        raise AssertionError(f"sharded forward launches {fwd['launches_per_rank']}, each {per_forward}")

    # ---- the free-running chain, against one rank and against the spread
    # of one rank's kernel path from its plain path
    ddpm = main_out["ddpm"]
    seeds = list(range(B))
    with torch.inference_mode():
        one = ddpm.sample(B, WIDTH_DDIM_STEPS, mode="ddim", seeds=seeds, data_format="NHWC")
        with _plain_layers():
            plain = ddpm.sample(B, WIDTH_DDIM_STEPS, mode="ddim", seeds=seeds, data_format="NHWC")
    two = torch.from_numpy(np.load(chain_out)).to("cuda")
    expected = launches_of(0, 0, halo=48 * WIDTH_DDIM_STEPS, gn_pair=50 * WIDTH_DDIM_STEPS)
    chain = {"rel_l2_vs_one_rank": _rel(two, one), "kernel_vs_plain_rel_l2": _rel(one, plain),
             "pixels_off_by_0.1_vs_one_rank": ((two - one).abs() > 0.1).double().mean().item(),
             "pixels_off_by_0.1_kernel_vs_plain": ((one - plain).abs() > 0.1).double().mean().item(),
             "launches_per_rank": [job0["ddim_launches"], job1["ddim_launches"]]}
    out["ddim"] = chain
    print(f"width axis, DDIM-{WIDTH_DDIM_STEPS} b{B} through DDPM.sample(world=) ({card}): {json.dumps(chain)}")
    if chain["launches_per_rank"] != [expected] * 2 or not math.isfinite(chain["rel_l2_vs_one_rank"]) \
            or chain["rel_l2_vs_one_rank"] > WIDTH_SPREAD * chain["kernel_vs_plain_rel_l2"]:
        raise AssertionError(f"sharded DDIM-{WIDTH_DDIM_STEPS}: {chain} (launches {expected} each; limit "
                             f"{WIDTH_SPREAD} x the kernel-vs-plain distance)")

    # ---- sample_and_save on phase 9's seeds, against phase 9's files
    files = sorted(os.listdir(samples))
    two_s = np.stack([np.load(os.path.join(samples, f))["sample"] for f in files])
    one_s = np.stack([np.load(os.path.join(eval_out["samples"], f))["sample"] for f in files])
    eval_ddpm, lidar, _ = setup_model(eval_out["ckpt"], dtype=torch.bfloat16, device="cuda")
    plain_s = []
    with torch.inference_mode(), _plain_layers():
        for lo in range(0, 2 * B, B):
            x = eval_ddpm.sample(B, 4, mode="ddim", seeds=list(range(lo, lo + B)))
            plain_s.append(postprocess(x, lidar).cpu().numpy())
    del eval_ddpm
    plain_s = np.concatenate(plain_s)
    t_two, t_one, t_plain = (torch.from_numpy(a) for a in (two_s, one_s, plain_s))
    diff = np.abs(two_s - one_s)
    expected = launches_of(0, 0, halo=48 * 8, gn_pair=50 * 8)  # every rank: 2 batches x 4 steps
    sas = {"files": len(files), "rel_l2_vs_one_rank": _rel(t_two, t_one),
           "kernel_vs_plain_rel_l2": _rel(t_plain, t_one), "max_abs_diff_m": float(diff.max()),
           "share_within_1e-3_m": float((diff <= 1e-3).mean()),
           "launches_per_rank": [sas0["launches"], sas1["launches"]], "seconds": sas0["seconds"]}
    out["sample_and_save"] = sas
    print(f"width axis, sample_and_save --mesh {WIDTH_MESH} {2 * B} samples b{B} 4 DDIM steps against phase 9's "
          f"files ({card}): {json.dumps(sas)}")
    if files != sorted(os.listdir(eval_out["samples"])) or sas["launches_per_rank"] != [expected] * 2 \
            or not np.isfinite(two_s).all() or sas["rel_l2_vs_one_rank"] > WIDTH_SPREAD * sas["kernel_vs_plain_rel_l2"]:
        raise AssertionError(f"sample_and_save --mesh {WIDTH_MESH}: {sas} (launches {expected} each; limit "
                             f"{WIDTH_SPREAD} x the kernel-vs-plain distance)")

    # ---- bench --mesh 1x2
    out["bench"] = {k: bench0.get(k) for k in ("value", "unit", "ranks", "per_rank_img_per_s", "mfu", "batch",
                                              "steps", "flow_euler1_img_per_s", "ddim2_img_per_s")}
    print(f"width axis, bench --mesh {WIDTH_MESH} b{B} 2 steps ({card}; ranks share the card): "
          f"{json.dumps(out['bench'])}")
    if not (math.isfinite(bench0["value"]) and bench0["value"] > 0 and bench0["unit"] == "img/s aggregate (2 dev)"):
        raise AssertionError(f"bench --mesh {WIDTH_MESH}: {out['bench']}")
    out["launches"] = job0["ddim_launches"]
    out["refinenet"] = _width_refinenet_checks(rn0, rn1, card)
    out["int8"] = _width_int8_checks(torch, main_out, ddpm, work, int8_sas_argv, (i8_0, i8_1), (i8sas0, i8sas1),
                                     i8bench0, int8_chain_out, int8_samples, card)
    return out


def _width_int8_checks(torch, main_out, ddpm, work, sas_argv, jobs, sas, bench0, chain_out, samples, card):
    """The int8 lane under ``--mesh 1x2`` (``width_int8_job``, then
    ``sample_and_save`` and ``bench`` under R2DM_TPU_INT8 in the ranks):
    every site bit for bit against one rank, a NaN in one rank's columns,
    exact launches (53 absmax + 53 halo'd quantize + 53 s8 conv and 50 + 50
    GN a forward), and the forward, the DDIM-4 chain and sample_and_save's
    files against one rank within WIDTH_SPREAD times one rank's int8
    kernel-vs-plain distance, measured here on the same inputs."""
    import numpy as np

    from r2dm_tpu_torch import setup_model
    from r2dm_tpu_torch.models import layers
    from r2dm_tpu_torch.sample_and_save import postprocess

    job0, job1 = jobs
    out = {k: job0[k] for k in ("sites", "sites_bit_for_bit", "forward_rel_l2", "forward_host_s", "collective_calls",
                                "collective_host_s")}
    out["nan_all"] = [job0["nan_all"], job1["nan_all"]]
    out["forward_launches"] = job0["forward_launches"]
    per_forward = launches_of(0, 0, gn_pair=50, s8_halo=INT8_SITES)
    net = ddpm.model
    x = randn(torch, (B, 64, 1024, 2), 40)
    cond = torch.linspace(-5.0, 5.0, B, device="cuda")
    seeds = list(range(B))
    layers.set_quant_conv(net, "w8a8")
    try:
        with torch.inference_mode():
            one = net(x, cond)
            one_chain = ddpm.sample(B, WIDTH_DDIM_STEPS, mode="ddim", seeds=seeds, data_format="NHWC")
            with _plain_layers():
                plain = net(x, cond)
                plain_chain = ddpm.sample(B, WIDTH_DDIM_STEPS, mode="ddim", seeds=seeds, data_format="NHWC")
    finally:
        layers.set_quant_conv(net, None)
    out["forward_kernel_vs_plain_rel_l2"] = _rel(one, plain)
    two_chain = torch.from_numpy(np.load(chain_out)).to("cuda")
    out["ddim"] = {"rel_l2_vs_one_rank": _rel(two_chain, one_chain),
                   "kernel_vs_plain_rel_l2": _rel(one_chain, plain_chain),
                   "launches_per_rank": [job0["ddim_launches"], job1["ddim_launches"]]}
    out["ddim_launches"] = job0["ddim_launches"]

    # sample_and_save under R2DM_TPU_INT8: one rank here, its plain path, the two ranks' files
    one_dir = os.path.join(work, "samples_int8_one")
    os.environ["R2DM_TPU_INT8"] = "1"
    try:
        one_sas = counted_main(torch, "r2dm_tpu_torch.sample_and_save", sas_argv + ["--output_dir", one_dir])
    finally:
        os.environ.pop("R2DM_TPU_INT8")
    files = sorted(os.listdir(samples))
    two_s, one_s = (np.stack([np.load(os.path.join(d, f))["sample"] for f in files]) for d in (samples, one_dir))
    eval_ddpm, lidar, _ = setup_model(main_out["ckpt"], dtype=torch.bfloat16, device="cuda")
    layers.set_quant_conv(eval_ddpm.model, "w8a8")
    with torch.inference_mode(), _plain_layers():
        plain_s = postprocess(eval_ddpm.sample(B, 2, mode="ddim", seeds=seeds), lidar).cpu().numpy()
    del eval_ddpm
    t_two, t_one, t_plain = (torch.from_numpy(a) for a in (two_s, one_s, plain_s))
    out["sample_and_save"] = {"files": len(files), "rel_l2_vs_one_rank": _rel(t_two, t_one),
                              "kernel_vs_plain_rel_l2": _rel(t_plain, t_one),
                              "max_abs_diff_m": float(np.abs(two_s - one_s).max()),
                              "launches_per_rank": [r["launches"] for r in sas],
                              "one_rank_launches": one_sas["launches"], "seconds": sas[0]["seconds"]}
    out["bench"] = {k: bench0.get(k) for k in ("value", "unit", "ranks", "per_rank_img_per_s", "int8", "batch",
                                              "steps")}
    print(f"width axis, the int8 lane under --mesh {WIDTH_MESH}, two gloo ranks on one card ({card}; a correctness "
          f"check, no scaling number): {json.dumps(out)}")
    failures = []
    if out["sites_bit_for_bit"] != INT8_SITES or out["sites"] != INT8_SITES:
        failures.append(f"{out['sites_bit_for_bit']} of {out['sites']} sites bit for bit, expected {INT8_SITES}")
    if out["nan_all"] != [True, True]:
        failures.append(f"a NaN in one rank's columns: all NaN {out['nan_all']}")
    if [job0["forward_launches"], job1["forward_launches"]] != [per_forward] * 2:
        failures.append(f"forward launches {job0['forward_launches']}, {job1['forward_launches']}; each {per_forward}")
    for name, rel, spread in (("forward", out["forward_rel_l2"], out["forward_kernel_vs_plain_rel_l2"]),
                              ("DDIM-4", out["ddim"]["rel_l2_vs_one_rank"], out["ddim"]["kernel_vs_plain_rel_l2"]),
                              ("sample_and_save", out["sample_and_save"]["rel_l2_vs_one_rank"],
                               out["sample_and_save"]["kernel_vs_plain_rel_l2"])):
        if not (math.isfinite(rel) and rel <= WIDTH_SPREAD * spread):
            failures.append(f"{name}: {rel} against one rank, limit {WIDTH_SPREAD} x {spread}")
    chain_expected = launches_of(0, 0, gn_pair=50 * WIDTH_DDIM_STEPS, s8_halo=INT8_SITES * WIDTH_DDIM_STEPS)
    if out["ddim"]["launches_per_rank"] != [chain_expected] * 2:
        failures.append(f"DDIM-4 launches {out['ddim']['launches_per_rank']}, each {chain_expected}")
    sas_expected = launches_of(0, 0, gn_pair=50 * 2, s8_halo=INT8_SITES * 2)
    if files != sorted(os.listdir(one_dir)) or len(files) != B or out["sample_and_save"]["launches_per_rank"] != [
            sas_expected] * 2 or not np.isfinite(two_s).all():
        failures.append(f"sample_and_save: {out['sample_and_save']} (launches {sas_expected} each)")
    if not (math.isfinite(bench0["value"]) and bench0["value"] > 0 and bench0["int8"] == "w8a8"
            and bench0["unit"] == "img/s aggregate (2 dev)"):
        failures.append(f"bench: {out['bench']}")
    if failures:
        raise AssertionError("int8 lane under the width axis: " + "; ".join(failures))
    return out


def phase_width_train(torch, tmp, card):
    """The width axis for training, ``--mesh 1x2`` as two gloo ranks sharing
    this card (a correctness check, no scaling number): one config-H b8
    loss + backward on each rank's columns (``width_train_job``) against
    one rank's kernel path, within WIDTH_SPREAD times that path's distance
    from its plain path, with exact launches (48 + 48 halo'd convs, 50 + 50
    GN stats/apply a rank, no ring-form conv, no one-launch GN) and the
    collectives' calls and host seconds; then ``python -m
    r2dm_tpu_torch.train --training.mesh_shape 1,2`` at config H, b8, on
    the synthetic set for WIDTH_TRAIN_STEPS steps against one rank's
    trainer with the same seed here: the loss each step, the weights'
    updates, the launches a rank a step."""
    import numpy as np

    from r2dm_tpu_torch import config as config_lib
    from r2dm_tpu_torch.checkpoint import load_checkpoint
    from r2dm_tpu_torch.inference import build_model
    from r2dm_tpu_torch.utils.weights import jax_from_state_dict

    work = os.path.join(tmp, "width_train")
    os.makedirs(work)
    steps = WIDTH_TRAIN_STEPS
    one_dir, two_dir = os.path.join(work, "one"), os.path.join(work, "two")

    def train_argv(out_dir):
        return ["--data.dataset", "synthetic", "--training.output_dir", out_dir, "--training.seed", "0",
                "--training.num_steps", str(steps), "--training.lr_warmup_steps", "1",
                "--training.steps_save_image", "100000", "--training.steps_save_model", "100000"]

    saved = os.environ.get("R2DM_SYNTH_SCANS")
    os.environ["R2DM_SYNTH_SCANS"] = str(B)
    rn_one_dir, rn_two_dir = os.path.join(work, "refinenet_one"), os.path.join(work, "refinenet_two")
    try:
        one = counted_main(torch, "r2dm_tpu_torch.train", train_argv(one_dir))
        rn_one = counted_main(torch, "r2dm_tpu_torch.train", REFINENET_FLAGS + train_argv(rn_one_dir))
    finally:
        if saved is None:
            os.environ.pop("R2DM_SYNTH_SCANS")
        else:
            os.environ["R2DM_SYNTH_SCANS"] = saved
    torch.cuda.empty_cache()  # the ranks share the card with this process
    mesh_flags = ["--training.mesh_shape", WIDTH_MESH.replace("x", ",")]
    jobs = [
        {"call": "width_train_job", "kwargs": {}, "env": {}},
        {"module": "r2dm_tpu_torch.train", "env": {"R2DM_SYNTH_SCANS": str(B)},
         "argv": train_argv(two_dir) + mesh_flags},
        {"call": "width_refinenet_train_job", "kwargs": {}, "env": {}},
        {"module": "r2dm_tpu_torch.train", "env": {"R2DM_SYNTH_SCANS": str(B)},
         "argv": REFINENET_FLAGS + train_argv(rn_two_dir) + mesh_flags},
    ]
    t0 = time.time()
    ranks = _two_ranks(work, [[{**job, "cwd": work} for job in jobs] for _ in range(2)])
    seconds = time.time() - t0
    (step0, step1), (cli0, cli1), (rn_step0, rn_step1), (rn_cli0, rn_cli1) = (
        [rank[i] for rank in ranks] for i in range(4))
    out = {"card": card, "seconds": seconds}

    # ---- one step against one rank's kernel path and its spread
    per_step = launches_of(0, 0, halo=96, gn_pair=50)
    out["step"] = {k: step0[k] for k in ("loss", "one_rank_loss", "loss_rel", "grad_rel_l2", "kernel_vs_plain_loss_rel",
                                         "kernel_vs_plain_grad_rel_l2", "step_host_s", "collective_calls",
                                         "collective_host_s")}
    out["step"]["launches_per_rank"] = [step0["launches"], step1["launches"]]
    print(f"width axis {WIDTH_MESH}, one b{B} loss + backward on each rank's columns against one rank ({card}; two "
          f"gloo ranks on one card, a correctness check): {json.dumps(out['step'])}")
    st = out["step"]
    if st["launches_per_rank"] != [per_step] * 2:
        raise AssertionError(f"sharded train step launches {st['launches_per_rank']}, each {per_step}")
    for what in ("loss", "grad"):
        rel = st["loss_rel" if what == "loss" else "grad_rel_l2"]
        spread = st[f"kernel_vs_plain_{what}_rel" if what == "loss" else "kernel_vs_plain_grad_rel_l2"]
        if not (math.isfinite(rel) and rel <= WIDTH_SPREAD * spread):
            raise AssertionError(f"sharded train step, {what}: {rel} against one rank, limit {WIDTH_SPREAD} x {spread}")

    # ---- the trainer
    expected = launches_of(0, 0, halo=96 * steps, gn_pair=50 * steps)
    launches = [cli0["launches"], cli1["launches"]]
    global_loss = [a + b for a, b in zip(cli0["losses"], cli1["losses"])]  # each rank's loss is its share
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(global_loss, one["losses"])]
    with torch.random.fork_rng(devices=[]):  # the trainer's initial weights, from its seed
        torch.manual_seed(0)
        w0 = jax_from_state_dict(build_model(config_lib.Config(), dtype=torch.bfloat16, device="cpu").state_dict())
    w = [load_checkpoint(os.path.join(d, "checkpoint.msgpack"))["weights"] for d in (one_dir, two_dir)]
    start, w1, w2 = (np.concatenate([np.asarray(a, np.float64).ravel() for a in _leaves(t["params"])])
                     for t in (w0, w[0], w[1]))
    upd_rel = float(np.linalg.norm(w2 - w1) / np.linalg.norm(w1 - start))
    out["train"] = {"one_rank_loss": one["losses"], "two_rank_loss": global_loss, "loss_rel": loss_rel,
                    "update_rel_l2": upd_rel, "launches_per_rank_per_step": {k: v // steps for k, v in launches[0].items()},
                    "seconds": [one["seconds"], cli0["seconds"]], "peak_bytes": [one["peak_bytes"], cli0["peak_bytes"]]}
    print(f"width axis {WIDTH_MESH}, python -m r2dm_tpu_torch.train --training.mesh_shape "
          f"{WIDTH_MESH.replace('x', ',')} {steps} steps b{B} against one rank ({card}): {json.dumps(out['train'])}")
    if launches != [expected] * 2 or one["launches"] != launches_of(50 * steps, 96 * steps):
        raise AssertionError(f"train launches: one rank {one['launches']}, two ranks {launches}; each {expected}")
    if not (len(global_loss) == steps and max(loss_rel) <= TRAIN_REL_L2 and upd_rel <= TWO_RANK_UPDATE_REL):
        raise AssertionError(f"the width trainer against one rank: loss {loss_rel} (limit {TRAIN_REL_L2}), "
                             f"update {upd_rel} (limit {TWO_RANK_UPDATE_REL})")
    out["launches_per_rank_per_step"] = out["train"]["launches_per_rank_per_step"]
    out["refinenet"] = _width_refinenet_train_checks(torch, rn_one, (rn_step0, rn_step1), (rn_cli0, rn_cli1),
                                                     rn_one_dir, rn_two_dir, card)
    return out


def _width_refinenet_train_checks(torch, one, steps, clis, one_dir, two_dir, card) -> dict:
    """The width training phase's RefineNet gates: one bf16 b8 loss +
    backward on the ranks' columns (``width_refinenet_train_job``) within
    TRAIN_REL_L2 of one rank's, the loss and the gradient; then ``python -m
    r2dm_tpu_torch.train --model.architecture refinenet
    --training.mesh_shape 1,2`` for WIDTH_TRAIN_STEPS steps against one
    rank's trainer (the loss each step within TRAIN_REL_L2, the weights'
    updates within TWO_RANK_UPDATE_REL); no hand-written launch anywhere."""
    import numpy as np

    from r2dm_tpu_torch import config as config_lib
    from r2dm_tpu_torch.checkpoint import load_checkpoint
    from r2dm_tpu_torch.inference import build_model
    from r2dm_tpu_torch.utils.weights import to_jax

    step0, step1 = steps
    out = {"step": {k: step0[k] for k in ("loss", "one_rank_loss", "loss_rel", "grad_rel_l2", "step_host_s",
                                          "collective_calls", "collective_host_s", "peak_bytes")}}
    global_loss = [a + b for a, b in zip(clis[0]["losses"], clis[1]["losses"])]  # each rank's loss is its share
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(global_loss, one["losses"])]
    cfg = config_lib.Config(model=config_lib.ModelConfig(architecture="refinenet", base_channels=128,
                                                         channel_multiplier=(1, 2, 2, 2)))
    with torch.random.fork_rng(devices=[]):  # the trainer's initial weights, from its seed
        torch.manual_seed(0)
        w0 = to_jax(build_model(cfg, dtype=torch.bfloat16, device="cpu").state_dict(), "refinenet")
    w = [load_checkpoint(os.path.join(d, "checkpoint.msgpack"))["weights"] for d in (one_dir, two_dir)]
    start, w1, w2 = (np.concatenate([np.asarray(a, np.float64).ravel() for a in _leaves(t["params"])])
                     for t in (w0, w[0], w[1]))
    out["train"] = {"one_rank_loss": one["losses"], "two_rank_loss": global_loss, "loss_rel": loss_rel,
                    "update_rel_l2": float(np.linalg.norm(w2 - w1) / np.linalg.norm(w1 - start)),
                    "seconds": [one["seconds"], clis[0]["seconds"]],
                    "peak_bytes": [one["peak_bytes"], clis[0]["peak_bytes"]]}
    launches = [step0["launches"], step1["launches"], one["launches"], clis[0]["launches"], clis[1]["launches"]]
    out["launches"] = step0["launches"]
    print(f"width axis {WIDTH_MESH}, the RefineNet: one b{B} loss + backward on each rank's columns and python -m "
          f"r2dm_tpu_torch.train --model.architecture refinenet --training.mesh_shape "
          f"{WIDTH_MESH.replace('x', ',')} {WIDTH_TRAIN_STEPS} steps, against one rank ({card}; two gloo ranks on "
          f"one card): {json.dumps(out)}")
    failures = []
    st = out["step"]
    if not (math.isfinite(st["loss_rel"]) and st["loss_rel"] <= TRAIN_REL_L2 and st["grad_rel_l2"] <= TRAIN_REL_L2):
        failures.append(f"one step: loss {st['loss_rel']}, gradient {st['grad_rel_l2']} (limit {TRAIN_REL_L2})")
    tr = out["train"]
    if not (len(global_loss) == WIDTH_TRAIN_STEPS and max(loss_rel) <= TRAIN_REL_L2
            and tr["update_rel_l2"] <= TWO_RANK_UPDATE_REL):
        failures.append(f"the trainer: loss {loss_rel} (limit {TRAIN_REL_L2}), update {tr['update_rel_l2']} "
                        f"(limit {TWO_RANK_UPDATE_REL})")
    if launches != [launches_of(0, 0)] * len(launches):
        failures.append(f"hand-written launches {launches}, expected none")
    if failures:
        raise AssertionError("the RefineNet under the width axis, training: " + "; ".join(failures))
    return out


def phase_width_kernels(torch, card):
    """The width axis's forms of the kernels at the shapes a rank gives
    them under --mesh 1x2 (W halved), against their plain versions (the
    gates of the one-rank forms), each timed beside its bound and plain
    version: the halo'd ring conv at every ResidualBlock shape (forward,
    and at its dx shape as a train step launches it), the GroupNorm stats +
    apply pair at every GN shape, and the int8 lane's halo'd quantize pass
    at every site shape of its forward (bit for bit)."""
    import torch.nn.functional as F

    from r2dm_tpu_torch.ops import act_ringconv, gn_silu

    torch.backends.cudnn.allow_tf32 = False
    G, eps = 8, 1e-6
    conv_rows, gn_rows = [], []
    worst = {"act_ringconv_halo": 0.0, "gn_stats": 0.0, "gn_apply": 0.0}
    for (C, Fo, H, W), count in CONV_SHAPES.items():
        Wl = W // 2
        x = randn(torch, (B, H, Wl, C), 41, torch.bfloat16)
        left, right = randn(torch, (B, H, 1, C), 42, torch.bfloat16), randn(torch, (B, H, 1, C), 43, torch.bfloat16)
        k = randn(torch, (3, 3, C, Fo), 44, scale=(9 * C) ** -0.5)
        bias = randn(torch, (Fo,), 45, scale=0.1)
        halo = (left, right)
        y = act_ringconv.fused_act_ringconv(x, None, None, k, bias, apply_act=False, halo=halo)
        ref = act_ringconv.act_ringconv_plain(x, None, None, k, bias, apply_act=False, halo=halo)
        err, scale = (y.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()
        if not err <= 1e-2 * scale:
            raise AssertionError(f"act_ringconv_halo {(C, Fo, H, Wl)}: max|err| {err:.3e} vs max|ref| {scale:.3e}")
        worst["act_ringconv_halo"] = max(worst["act_ringconv_halo"], err)
        xp = torch.cat([left, x, right], dim=2)
        xp = F.pad(xp, (0, 0, 0, 0, 1, 1)).permute(0, 3, 1, 2)
        wt = k.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bb = bias.to(torch.bfloat16)
        flops = 2 * 9 * C * Fo * B * H * Wl
        nbytes = B * H * (Wl + 2) * C * 2 + B * H * Wl * Fo * 2 + 9 * C * Fo * 2 + Fo * 4
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        # its dx in a train step: the same halo'd kernel on dy (F channels) and
        # dy's strips, the kernel flipped with its channels swapped
        dy = randn(torch, (B, H, Wl, Fo), 49, torch.bfloat16)
        dhalo = (randn(torch, (B, H, 1, Fo), 50, torch.bfloat16), randn(torch, (B, H, 1, Fo), 51, torch.bfloat16))
        kt = k.flip(0, 1).transpose(2, 3).contiguous()
        zeros = torch.zeros(C, device="cuda")
        dx = act_ringconv.act_ringconv_halo(dy, *dhalo, None, None, kt, zeros, apply_act=False)
        dx_ref = act_ringconv.act_ringconv_plain(dy, None, None, kt, zeros, apply_act=False, halo=dhalo)
        dx_err, dx_scale = (dx.float() - dx_ref.float()).abs().max().item(), dx_ref.float().abs().max().item()
        if not dx_err <= 1e-2 * dx_scale:
            raise AssertionError(f"act_ringconv_halo dx {(Fo, C, H, Wl)}: max|err| {dx_err:.3e} vs {dx_scale:.3e}")
        worst["act_ringconv_halo"] = max(worst["act_ringconv_halo"], dx_err)
        dx_bytes = (B * H * (Wl + 2) * Fo * 2 + B * H * Wl * C * 2 + 9 * C * Fo * 2 + C * 4) / PEAK_BYTES * 1e3
        conv_rows.append({
            "cin": C, "f": Fo, "h": H, "w": Wl, "per_forward": count, "max_abs_err": err,
            "dx_ms": graph_ms(torch, lambda: act_ringconv.act_ringconv_halo(dy, *dhalo, None, None, kt, zeros,
                                                                            apply_act=False)),
            "dx_bound_ms": max(dx_bytes, t_ops), "dx_max_abs_err": dx_err,
            "ms": graph_ms(torch, lambda: act_ringconv.fused_act_ringconv(x, None, None, k, bias, apply_act=False,
                                                                          halo=halo)),
            "plain_ms": graph_ms(torch, lambda: act_ringconv.act_ringconv_plain(x, None, None, k, bias,
                                                                                apply_act=False, halo=halo)),
            "library_ms": graph_ms(torch, lambda: F.conv2d(xp, wt, bb)), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    for C, H, W in GN_SHAPES:
        Wl = W // 2
        x = randn(torch, (B, H, Wl, C), 46, torch.bfloat16, offset=0.1)
        for per_batch in (False, True):
            aff = (B, C) if per_batch else (C,)
            gain, shift = randn(torch, aff, 47, scale=0.5, offset=1.0), randn(torch, aff, 48, scale=0.5)
            count = H * W * (C // G)  # the whole image's: this rank's columns and the other's
            sums = gn_silu.gn_stats(x)
            ref_sums = gn_silu.gn_stats_plain(x)
            s_err = ((sums - ref_sums).abs() / ref_sums.abs().clamp_min(1.0)).max().item()
            if not s_err <= 1e-5:
                raise AssertionError(f"gn_stats {(C, H, Wl)}: relative error {s_err:.3e} (fp32 sums, limit 1e-5)")
            worst["gn_stats"] = max(worst["gn_stats"], (sums - ref_sums).abs().max().item())
            both = sums * 2  # as if the other rank's columns summed the same
            for silu in (True, False):
                y = gn_silu.gn_apply(x, both, count, gain, shift, G, eps, silu)
                ref = gn_silu.gn_apply_plain(x, both, count, gain, shift, G, eps, silu)
                err = (y.float() - ref.float()).abs()
                # bf16 output: rtol = atol = 2e-2, the one-launch form's gate
                if not bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all()):
                    raise AssertionError(f"gn_apply {(C, H, Wl)} silu={silu}: max|err| {err.max().item():.3e}")
                worst["gn_apply"] = max(worst["gn_apply"], err.max().item())
        gain, shift = randn(torch, (C,), 47), randn(torch, (C,), 48)
        n = x.numel()
        st_bytes, st_ops = (n * 2 + 2 * B * C * 4) / PEAK_BYTES * 1e3, 3 * n / PEAK_FP32_FLOPS * 1e3
        ap_bytes, ap_ops = (2 * n * 2 + 2 * B * C * 4) / PEAK_BYTES * 1e3, 10 * n / PEAK_FP32_FLOPS * 1e3
        both = gn_silu.gn_stats(x) * 2
        gn_rows.append({
            "c": C, "h": H, "w": Wl,
            "stats_ms": graph_ms(torch, lambda: gn_silu.gn_stats(x)),
            "stats_plain_ms": graph_ms(torch, lambda: gn_silu.gn_stats_plain(x)),
            "stats_bound_ms": max(st_bytes, st_ops), "stats_bound_by": "bytes" if st_bytes >= st_ops else "operations",
            "apply_ms": graph_ms(torch, lambda: gn_silu.gn_apply(x, both, H * W * (C // G), gain, shift, G, eps)),
            "apply_plain_ms": graph_ms(torch, lambda: gn_silu.gn_apply_plain(x, both, H * W * (C // G), gain, shift,
                                                                             G, eps)),
            "apply_bound_ms": max(ap_bytes, ap_ops), "apply_bound_by": "bytes" if ap_bytes >= ap_ops else "operations",
            "one_launch_ms": graph_ms(torch, lambda: gn_silu.fused_group_norm_silu(x, gain, shift, G, eps))})
    conv_total = {k: sum(r[k] * r["per_forward"] for r in conv_rows) for k in ("ms", "plain_ms", "library_ms",
                                                                             "bound_ms", "dx_ms", "dx_bound_ms")}
    print(f"width axis, the halo'd ring conv at every ResidualBlock shape, W halved, b{B} ({card}): "
          + json.dumps({"shapes": conv_rows, "per_forward_total": conv_total}))
    print(f"width axis, GroupNorm stats + apply at every GN shape, W halved, b{B} ({card}): " + json.dumps(gn_rows))
    quant_rows, quant_total = _width_quantize_kernel(torch, card)
    worst["act_quantize_halo"] = 0.0  # bit for bit, or the phase failed
    return {"conv": conv_rows, "gn": gn_rows, "worst": worst, "conv_total": conv_total, "quantize": quant_rows,
            "quantize_total": quant_total}


def _width_quantize_kernel(torch, card):
    """The int8 lane's halo'd quantize pass at every site shape of a config-H
    b8 forward with W halved (the sites from one b1 forward of a config-H
    network on the lane): the s8 layout bit for bit against its plain
    version, ties included, then timed beside its bound (x and the two
    strips read once, xq written once) and its plain version."""
    from r2dm_tpu_torch import config as config_lib
    from r2dm_tpu_torch.inference import build_model
    from r2dm_tpu_torch.models import layers
    from r2dm_tpu_torch.ops import quant

    net = layers.set_quant_conv(build_model(config_lib.Config(), dtype=torch.bfloat16, device="cuda"), "w8a8")
    sites = _lane_sites(torch, net, torch.zeros(1, 64, 1024, 2, device="cuda"), torch.zeros(1, device="cuda"))
    del net
    if len(sites) != INT8_SITES:
        raise AssertionError(f"the lane quantized {len(sites)} convs a forward, expected {INT8_SITES}")
    unique = {}
    for shape, x_dtype, _, _ in sites:
        key = (*shape[1:], x_dtype)
        unique[key] = unique.get(key, 0) + 1
    rows = []
    for (H, W, C, x_dtype), count in unique.items():
        Wl = W // 2
        x = randn(torch, (B, H, Wl, C), 52, x_dtype, scale=1.5)
        flat = x.view(-1)
        flat[::7] = ((torch.arange(flat.numel(), device="cuda") % 9 - 4) + 0.5)[::7].to(x_dtype)
        flat[0] = 127.0  # the scale is then 1, and every seventh value a tie
        halo = (randn(torch, (B, H, 1, C), 53, x_dtype, scale=1.5), randn(torch, (B, H, 1, C), 54, x_dtype, scale=1.5))
        amax = quant.act_absmax(x)
        xq = quant.act_quantize(x, amax, halo=halo)
        if not torch.equal(xq, quant.act_quantize_plain(x, amax, halo=halo)):
            raise AssertionError(f"act_quantize_halo {(B, H, Wl, C)} {x_dtype}: not its plain version bit for bit")
        nbytes = x.numel() * x.element_size() + 2 * halo[0].numel() * x.element_size() + xq.numel()
        rows.append({"h": H, "w": Wl, "c": C, "x_dtype": str(x_dtype).split(".")[-1], "per_forward": count,
                     "ms": graph_ms(torch, lambda: quant.act_quantize(x, amax, halo=halo)),
                     "plain_ms": graph_ms(torch, lambda: quant.act_quantize_plain(x, amax, halo=halo)),
                     "ring_form_ms": graph_ms(torch, lambda: quant.act_quantize(x, amax)),
                     "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes"})
    total = {k: sum(r[k] * r["per_forward"] for r in rows) for k in ("ms", "plain_ms", "ring_form_ms", "bound_ms")}
    print(f"width axis, the int8 lane's halo'd quantize pass at every site shape, W halved, b{B} ({card}; bit for "
          f"bit against its plain version): " + json.dumps({"shapes": rows, "per_forward_total": total}))
    return rows, total


def width_rows(width, kern) -> list:
    """The kernels line's rows of the width axis's three forms: launches from
    its main path (a rank's DDIM-4 chain through ``DDPM.sample(world=)``),
    times at the level-1 conv shape (64 -> 64 at 64x512, b8) and the GN row's
    shape of the one-rank line (512 channels at 8x64, b8)."""
    conv = next(r for r in kern["conv"] if (r["cin"], r["f"], r["h"]) == (64, 64, 64))
    gn = next(r for r in kern["gn"] if (r["c"], r["h"]) == (512, 8))
    q = next(r for r in kern["quantize"] if (r["c"], r["h"], r["x_dtype"]) == (64, 64, "bfloat16"))
    rows = [{"name": "act_ringconv_halo", "ms": conv["ms"], "plain_ms": conv["plain_ms"], "bound_ms": conv["bound_ms"],
             "bound_by": conv["bound_by"], "library_ms": conv["library_ms"], "dx_ms": conv["dx_ms"],
             "dx_bound_ms": conv["dx_bound_ms"], "shape": [B, conv["h"], conv["w"], conv["cin"], conv["f"]],
             "per_forward_total": kern["conv_total"]}]
    for name in ("gn_stats", "gn_apply"):
        key = name[3:]
        # no one PyTorch call computes the split form's sums or its apply
        rows.append({"name": name, "ms": gn[f"{key}_ms"], "plain_ms": gn[f"{key}_plain_ms"],
                     "bound_ms": gn[f"{key}_bound_ms"], "bound_by": gn[f"{key}_bound_by"], "library_ms": None,
                     "shape": [B, gn["h"], gn["w"], gn["c"]]})
    # no one PyTorch call quantizes to s8; its launches are the int8 lane's
    # main path under the width axis, a DDIM-4 chain through DDPM.sample(world=)
    rows.append({"name": "act_quantize_halo", "ms": q["ms"], "plain_ms": q["plain_ms"], "bound_ms": q["bound_ms"],
                 "bound_by": q["bound_by"], "library_ms": None, "ring_form_ms": q["ring_form_ms"],
                 "shape": [B, q["h"], q["w"], q["c"]], "per_forward_total": kern["quantize_total"]})
    for row in rows:
        src, replaces = SOURCES[row["name"]]
        name = row["name"]
        launches = width["int8"]["ddim_launches"][name] if name == "act_quantize_halo" else width["launches"][name]
        row.update({"route": "cuda", "source": src, "replaces": replaces, "launches": launches,
                    "max_abs_err": kern["worst"][name]})
    return rows


def phase_reflow(torch, main_out, tmp, card):
    """``r2dm_tpu_torch.reflow`` (the entry point ``python -m`` runs) on the
    random config-H network as a flow checkpoint: exact launch counts of the
    teacher and of the fine-tune, seconds and peak memory; the result loads
    through setup_model and samples one finite euler step."""
    import contextlib
    import io

    from r2dm_tpu_torch import ops, reflow, setup_model

    work = os.path.join(tmp, "reflow")
    os.makedirs(work)
    ckpt = torch.load(main_out["ckpt"], map_location="cpu", weights_only=False)
    ckpt["cfg"]["diffusion"]["timestep_type"] = "flow"
    src = os.path.join(work, "r2dm-h-random-flow.pth")
    torch.save(ckpt, src)
    del ckpt
    dst = os.path.join(work, "reflowed.msgpack")
    counts = {}
    real_step = reflow.reflow_step

    def counted_step(*args, **kwargs):  # the teacher's launches end where the fine-tune begins
        if "teacher" not in counts:
            counts["teacher"] = teacher.stop()  # its forwards replay a CUDA graph: the card's kernels
            counts["teacher_s"] = time.time() - t0
            ops.reset_launch_counts()
        return real_step(*args, **kwargs)

    argv = ["--ckpt", src, "--out", dst] + [f"--{k}={v}" for k, v in REFLOW_ARGS.items()]
    text = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reflow.reflow_step = counted_step
    teacher = device_launches(torch).__enter__()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(text):
            rc = reflow.main(argv)
        torch.cuda.synchronize()
    finally:
        teacher.stop()
        reflow.reflow_step = real_step
    seconds = time.time() - t0
    counts["finetune"] = _launches(ops)
    teacher_forwards = REFLOW_ARGS["num_pairs"] // REFLOW_ARGS["batch_size"] * REFLOW_ARGS["teacher_steps"]
    expected = {"teacher": launches_of(50 * teacher_forwards, 48 * teacher_forwards),
                "finetune": launches_of(50 * REFLOW_ARGS["train_steps"], 96 * REFLOW_ARGS["train_steps"])}
    peak = torch.cuda.max_memory_allocated() - base
    ddpm, _, cfg = setup_model(dst, dtype=torch.bfloat16, device="cuda")
    x = ddpm.sample(B, 1, mode="euler", seeds=range(B))
    finite = bool(torch.isfinite(x).all())
    losses = [ln for ln in text.getvalue().splitlines() if ln.startswith("reflow step")]
    result = {"seconds": seconds, "teacher_seconds": counts.get("teacher_s"), "peak_bytes": peak,
              "launches": {k: counts.get(k) for k in ("teacher", "finetune")}, "losses": losses,
              "sample_shape": list(x.shape), "sample_finite": finite, "timestep_type": cfg.diffusion.timestep_type}
    print(f"reflow {json.dumps(REFLOW_ARGS)} at config H ({card}): {json.dumps(result)}")
    if rc != 0 or result["launches"] != expected or not finite or tuple(x.shape) != (B, 2, 64, 1024) \
            or cfg.diffusion.timestep_type != "flow":
        raise AssertionError(f"reflow: {result}, expected launches {expected}")
    return result


def quality_leg_runner(torch, legs: list):
    """A leg runner of the protocols (``quality.Leg``): the leg's module's
    main in this process, in the leg's working directory, so the launch
    counters see it (zeroed before, read after); records each leg's module,
    tag, seconds and launches, the reflow's teacher and fine-tune apart."""
    import contextlib
    import importlib
    import io

    from r2dm_tpu_torch import ops, reflow

    def run(module, argv, cwd):
        mod = importlib.import_module(f"r2dm_tpu_torch.{module}")
        counts = {}
        real_step = reflow.reflow_step

        def counted_step(*args, **kwargs):  # the teacher's launches end where the fine-tune begins
            if "teacher" not in counts:
                counts["teacher"] = ran.stop()
                ops.reset_launch_counts()
            return real_step(*args, **kwargs)

        out, saved = io.StringIO(), os.getcwd()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        # sampling replays the forward's CUDA graph: its launches are the
        # kernels that ran on the card; training's, the wrappers' counts
        ran = device_launches(torch).__enter__() if module in ("sample_and_save", "reflow") else None
        t0 = time.time()
        reflow.reflow_step = counted_step
        try:
            os.chdir(cwd)
            with contextlib.redirect_stdout(out):
                rc = mod.main(argv) if module in ("train", "reflow") else mod.main(mod.parse_args(argv))
            torch.cuda.synchronize()
        finally:
            if ran is not None:
                ran.stop()
            reflow.reflow_step = real_step
            os.chdir(saved)
        if rc not in (0, None):
            raise AssertionError(f"python -m r2dm_tpu_torch.{module} exited with {rc}:\n{out.getvalue()[-2000:]}")
        if module == "reflow":
            launches = {"teacher": counts.get("teacher"), "finetune": _launches(ops)}
        else:
            launches = ran.counts if module == "sample_and_save" else _launches(ops)
        dir_flag = {"sample_and_save": "--output_dir", "evaluate": "--sample_dir"}.get(module)
        tag = os.path.basename(argv[argv.index(dir_flag) + 1])[len("samples_"):] if dir_flag else None
        legs.append({"module": module, "tag": tag, "seconds": time.time() - t0, "launches": launches})

    return run


def _quality_expected(name: str) -> list:
    """(module, tag, launches) of every leg of protocol ``name`` on a fresh
    workdir: a train step 50 GN + 96 conv, a forward 50 + 48, evaluate
    none."""
    from r2dm_tpu_torch import ddim_quality_check, flow_quality_check, quality

    def fwd(n):
        return launches_of(50 * n, 48 * n)

    size = quality.sizes(False)
    batches = math.ceil(QUALITY_SAMPLES / size.sample_batch)
    legs = [("train", None, launches_of(50 * size.train_steps, 96 * size.train_steps))]
    if name == "ddim":
        specs = [(f"{mode}{steps}", steps) for steps, mode in ddim_quality_check.SPECS]
    else:
        r = dict(zip(*[iter(flow_quality_check.reflow_args(False))] * 2))
        teacher = math.ceil(int(r["--num_pairs"]) / int(r["--batch_size"])) * int(r["--teacher_steps"])
        finetune = int(r["--train_steps"])
        legs.append(("reflow", None, {"teacher": fwd(teacher), "finetune": launches_of(50 * finetune, 96 * finetune)}))
        specs = [(tag, steps) for _, tag, steps in flow_quality_check.LEGS]
    for tag, steps in specs:
        legs += [("sample_and_save", tag, fwd(batches * steps)), ("evaluate", tag, fwd(0))]
    return legs


def _empty_scan(torch, work: str, tag: str) -> bool:
    """Whether a sample of ``tag`` has no point in the BEV histogram's range
    after the evaluation gate: its normalised histogram is 0/0, so its BEV
    MMD is NaN (in the reference and the JAX package as in the port)."""
    import numpy as np

    from r2dm_tpu_torch.evaluate import gated
    from r2dm_tpu_torch.metrics import bev

    d = os.path.join(work, f"samples_{tag}")
    scans = np.stack([np.load(os.path.join(d, f))["sample"] for f in sorted(os.listdir(d)) if f.endswith(".npz")])
    clouds = torch.from_numpy(scans[:, 1:4] * gated(scans[:, 0:1])).reshape(len(scans), 3, -1).transpose(1, 2)
    return bool((bev.point_cloud_to_histogram(clouds).reshape(len(scans), -1).sum(1) == 0).any())


def _mtimes(root: str) -> dict:
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns for d, _, files in os.walk(root) for f in files}


def _quality_protocol(torch, tmp, card, name: str) -> dict:
    import contextlib
    import io

    from r2dm_tpu_torch import ddim_quality_check, flow_quality_check, quality

    module = {"ddim": ddim_quality_check, "flow": flow_quality_check}[name]
    work = os.path.join(tmp, f"quality_{name}")
    legs, text = [], io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(text):
        rc = module.main([work, str(QUALITY_SAMPLES)], run=quality_leg_runner(torch, legs))
    seconds = time.time() - t0
    expected = _quality_expected(name)
    tags = [t for m, t, _ in expected if m == "evaluate"]
    table = quality.summary(work, QUALITY_SAMPLES, tags, module.KEY)
    printed = json.dumps(table, indent=2)
    got = [(leg["module"], leg["tag"], leg["launches"]) for leg in legs]
    per_leg = [{k: leg[k] for k in ("module", "tag", "seconds")} for leg in legs]
    print(f"quality {name} protocol at config H ({card}): {seconds:.1f} s in all; seconds a leg {json.dumps(per_leg)}")
    print(f"quality {name} table: {json.dumps(table)}")
    if rc != 0 or printed not in text.getvalue():
        raise AssertionError(f"{name} protocol: rc {rc}, its table not printed:\n{text.getvalue()[-2000:]}")
    if got != expected:
        raise AssertionError(f"{name} protocol legs and launches {got} != {expected}")
    rows = table[module.KEY]
    want_rows = ["img.frechet_distance", "img.squared_mmd", "pts.frechet_distance", "pts.squared_mmd", "bev.jsd",
                 "bev.mmd"]
    empty = {t: _empty_scan(torch, work, t) for t in tags}
    if list(rows) != want_rows or any(list(r) != tags for r in rows.values()):
        raise AssertionError(f"{name} table rows {list(rows)}, tags {[list(r) for r in rows.values()]}")
    # finite, but the BEV MMD of a leg with an empty scan (NaN there)
    bad = [(row, t, v) for row, r in rows.items() for t, v in r.items()
           if math.isfinite(v) == (row == "bev.mmd" and empty[t])]
    if bad:
        raise AssertionError(f"{name} table: values {bad} (legs with an empty scan: {empty})")

    # the second invocation, a process on the same workdir: no leg, the same table
    before = _mtimes(work)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", module.__name__, work, str(QUALITY_SAMPLES)],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=300)
    again = time.time() - t0
    after = _mtimes(work)
    print(f"quality {name} again, python -m {module.__name__} on the same workdir: rc {proc.returncode}, "
          f"{again:.1f} s, the same table {printed in proc.stdout}, files unchanged {after == before}")
    if proc.returncode != 0 or "leg " in proc.stdout or printed not in proc.stdout or after != before:
        raise AssertionError(f"{name} protocol again: rc {proc.returncode}\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    totals = {}
    for leg in legs:
        for counts in (leg["launches"].values() if leg["module"] == "reflow" else [leg["launches"]]):
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
    return {"seconds": seconds, "again_seconds": again, "legs": per_leg, "launches": totals,
            "empty_scans": empty, "table": table}


def phase_quality(torch, tmp, card):
    """Both relative-quality protocols at config H, full width, on the card,
    each on a fresh workdir with QUALITY_ENV's cuts: their legs in this
    process through ``quality_leg_runner`` (exact launches a leg), their
    tables (the expected tags and rows, finite but where a leg has an empty
    scan), then each protocol again as a process, which runs no leg."""
    off = ("R2DM_DDIMQ_SMOKE", "R2DM_FLOWQ_SMOKE", "R2DM_QUALITY_TRAIN_ARGS", "R2DM_QUALITY_TRAIN_ONLY")
    saved = {k: os.environ.get(k) for k in (*QUALITY_ENV, *off)}
    os.environ.update(QUALITY_ENV)
    for k in off:
        os.environ.pop(k, None)
    try:
        return {name: _quality_protocol(torch, tmp, card, name) for name in ("ddim", "flow")}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _lane_sites(torch, net, x, cond):
    """Each ring_conv_w8a8 call of one forward under the lane: (x shape, x
    dtype, F, out dtype), in order."""
    from r2dm_tpu_torch.models import layers

    sites, real = [], layers.ring_conv_w8a8

    def recorded(x, kernel, bias, out_dtype=None, packed=None, width=None):
        sites.append((tuple(x.shape), x.dtype, kernel.shape[3], out_dtype or x.dtype))
        return real(x, kernel, bias, out_dtype, packed, width=width)

    layers.ring_conv_w8a8 = recorded
    try:
        with torch.inference_mode():  # the eager body: a graphed forward's first call runs its Python twice
            net._forward(x, cond)
    finally:
        layers.ring_conv_w8a8 = real
    return sites


def phase_int8(torch, main_out, tmp, card):
    """The int8 (W8A8) serving lane at config H on phase 4's random network:
    the s8 kernel and the absmax reduction against their plain versions at
    every site the lane serves at b8 (the s32 sums equal, the bf16 output
    within one bf16 step, the absmax equal), a b8 forward with exact launches
    and its distance from the bf16 forward, a DDIM-16 b8 chain (the lane's
    main path: counters zeroed before, read after), ``generate --int8`` (b2)
    and ``sample_and_save`` under R2DM_TPU_INT8 (b8), then each site's ms
    beside its bound, the plain version and the bf16 kernel at that shape,
    and the device time of a b8 and a b256 forward on both lanes."""
    import numpy as np

    from r2dm_tpu_torch.models import layers
    from r2dm_tpu_torch.ops import act_ringconv, quant

    ddpm = main_out["ddpm"]
    net = ddpm.model
    H, W = ddpm.sampling_shape[:2]
    out = {}
    xin = randn(torch, (B, H, W, 2), 30)
    cond = torch.linspace(-5.0, 5.0, B, device="cuda")
    layers.set_quant_conv(net, "w8a8")
    try:
        sites = _lane_sites(torch, net, xin, cond)
        unique = {}
        for s in sites:
            unique[s] = unique.get(s, 0) + 1
        print(f"int8 lane sites of one b{B} forward: {len(sites)} calls, {len(unique)} shapes "
              + json.dumps([[list(k[0]), str(k[1]), k[2], str(k[3]), n] for k, n in unique.items()]))
        if len(sites) != INT8_SITES:
            raise AssertionError(f"the lane quantized {len(sites)} convs a forward, expected {INT8_SITES}")

        # (b) one forward: exact launches, and the distance from the bf16 forward
        with torch.inference_mode():
            with device_launches(torch) as ran:
                y8 = net(xin, cond)
            launches = ran.counts
            layers.set_quant_conv(net, None)
            y16 = net(xin, cond)
            layers.set_quant_conv(net, "w8a8")
        rel = ((y8 - y16).norm() / y16.norm()).item()
        cos = (torch.sum(y8 * y16) / (y8.norm() * y16.norm())).item()
        out["forward"] = {"launches": launches, "rel_l2_vs_bf16": rel, "cos_vs_bf16": cos}
        print(f"int8 forward b{B} ({card}): {json.dumps(out['forward'])} (JAX's gate: rel < 0.25, cos > 0.97)")
        if launches != launches_of(50, 0, INT8_SITES) or not (rel < 0.25 and cos > 0.97):
            raise AssertionError(f"int8 forward: {out['forward']}")

        # the lane's main path: a DDIM-16 b8 chain, counters zeroed just before
        ddpm.sample(B, 1, mode="ddim", seeds=range(B))  # warm-up
        with device_launches(torch) as ran:
            ddpm.sample(B, INT8_DDIM_STEPS, mode="ddim", seeds=range(B))
        launches = ran.counts
        torch.cuda.synchronize()
        t0 = time.time()  # timed apart from the profiled run
        x = ddpm.sample(B, INT8_DDIM_STEPS, mode="ddim", seeds=range(B))
        torch.cuda.synchronize()
        chain_s = time.time() - t0
        peak = x.abs().max().item()
        gap = (x - main_out["ddim16"]).abs().max().item()
        out["ddim16"] = {"seconds": chain_s, "img_per_s": B / chain_s, "launches": launches, "max_abs": peak,
                         "max_abs_diff_vs_bf16_chain": gap}
        print(f"int8 ddim{INT8_DDIM_STEPS} b{B} ({card}): {json.dumps(out['ddim16'])}")
        if launches != launches_of(50 * INT8_DDIM_STEPS, 0, INT8_SITES * INT8_DDIM_STEPS) \
                or not (bool(torch.isfinite(x).all()) and peak <= 1.02):
            raise AssertionError(f"int8 ddim chain: {out['ddim16']}")
        out["launches"] = launches
    finally:
        layers.set_quant_conv(net, None)

    # generate --int8 (b2, 4 DDIM steps) and sample_and_save under R2DM_TPU_INT8
    gen_dir = os.path.join(tmp, "generate_int8")
    with device_launches(torch) as ran:
        _run_cli("r2dm_tpu_torch.generate", ["--ckpt", main_out["ckpt"], "--int8", "--batch_size", "2",
                                             "--sampling_steps", "4", "--mode", "ddim", "--out_dir", gen_dir])
    gen = ran.counts
    sizes = {n: _png_size(os.path.join(gen_dir, n)) for n in ("samples_img.png", "samples_bev.png")}
    sas_dir = os.path.join(tmp, "samples_int8")
    os.environ["R2DM_TPU_INT8"] = "1"
    try:
        with device_launches(torch) as ran:
            _run_cli("r2dm_tpu_torch.sample_and_save", ["--ckpt", main_out["ckpt"], "--output_dir", sas_dir,
                                                        "--num_samples", str(B), "--batch_size", str(B),
                                                        "--num_steps", "2", "--mode", "ddim"])
        sas = ran.counts
    finally:
        os.environ.pop("R2DM_TPU_INT8")
    files = sorted(os.listdir(sas_dir))
    finite = all(np.isfinite(np.load(os.path.join(sas_dir, f))["sample"]).all() for f in files)
    out["generate"], out["sample_and_save"] = gen, sas
    print(f"generate --int8 b2: launches {json.dumps(gen)}, PNGs {json.dumps(sizes)}; sample_and_save under "
          f"R2DM_TPU_INT8 b{B}: launches {json.dumps(sas)}, {len(files)} files, finite {finite}")
    if gen != launches_of(50 * 4, 0, INT8_SITES * 4) or sizes["samples_img.png"] != (2 * 2 * H, W):
        raise AssertionError(f"generate --int8: {gen}, {sizes}")
    if sas != launches_of(50 * 2, 0, INT8_SITES * 2) or len(files) != B or not finite:
        raise AssertionError(f"sample_and_save under R2DM_TPU_INT8: {sas}, {files}")

    # (a) each site the lane serves, at b8: the three kernels against their
    # plain versions, then times; registers and spills from the build log
    from r2dm_tpu_torch.ops import build

    ptxas = ptxas_kernels(build.build_log("w8a8_ringconv"))
    mangled = {torch.bfloat16: "I13__nv_bfloat16", torch.float32: "If"}  # template arguments in kernel names

    def regs_of(name: str) -> dict:
        return next(({"registers": v["registers"], "spill_bytes": v["spill_bytes"]} for k, v in ptxas.items()
                     if name in k), {"registers": None, "spill_bytes": None})

    def nbytes(t) -> int:
        return t.numel() * t.element_size()

    per_site, worst, worst_absmax, worst_xq = [], 0.0, 0.0, 0
    for i, ((shape, x_dtype, Fo, out_dtype), count) in enumerate(unique.items()):
        Bs, Hs, Ws, C = shape
        x = randn(torch, shape, 31 + i, x_dtype, scale=1.5)
        k = randn(torch, (3, 3, C, Fo), 50 + i, scale=(9 * C) ** -0.5)
        bias = randn(torch, (Fo,), 70 + i, scale=0.1)
        packed = quant.pack_weight(k)
        with torch.inference_mode():
            amax = quant.act_absmax(x)
            ref_amax = x.float().abs().max()
            xq = quant.act_quantize(x, amax)
            ref_xq = quant.act_quantize_plain(x, amax)
            acc = quant.w8a8_accumulators(x, k, packed)
            ref_acc = quant.conv_s8(quant.act_qparams(x)[0], quant.weight_qparams(k)[0])
            y = quant.ring_conv_w8a8(x, k, bias, out_dtype, packed)
            ref = quant.ring_conv_w8a8_plain(x, k, bias, out_dtype)
            y32 = quant.ring_conv_w8a8(x, k, bias, torch.float32, packed)
            ref32 = quant.ring_conv_w8a8_plain(x, k, bias, torch.float32)
        equal = {"absmax": amax.item() == ref_amax.item(), "xq": torch.equal(xq, ref_xq),
                 "s32": torch.equal(acc, ref_acc), "fp32": torch.equal(y32, ref32), str(out_dtype): torch.equal(y, ref)}
        worst = max(worst, (y.float() - ref.float()).abs().max().item())
        worst_absmax = max(worst_absmax, abs(amax.item() - ref_amax.item()))
        worst_xq = max(worst_xq, (xq.int() - ref_xq.int()).abs().max().item())
        if not all(equal.values()):
            raise AssertionError(f"int8 lane at {shape} -> {Fo}: equal to the plain version {equal}")
        with torch.inference_mode():
            ms = graph_ms(torch, lambda: quant.ring_conv_s8(xq, amax, packed, bias, out_dtype))
            plain = cuda_ms(torch, lambda: quant.ring_conv_s8_plain(xq, amax, packed, bias, out_dtype), iters=2,
                            warmup=1)
            q_ms = graph_ms(torch, lambda: quant.act_quantize(x, amax))
            q_plain = graph_ms(torch, lambda: quant.act_quantize_plain(x, amax))
            lane_ms = graph_ms(torch, lambda: quant.ring_conv_w8a8(x, k, bias, out_dtype, packed, amax))
            absmax_ms = graph_ms(torch, lambda: quant.act_absmax(x))
            absmax_lib = graph_ms(torch, lambda: torch.linalg.vector_norm(x, float("inf")))
            absmax_plain = graph_ms(torch, lambda: x.to(torch.float32).abs().amax())
            bf16_ms = None
            if C % 8 == 0 and Fo % 8 == 0:
                xb = x.to(torch.bfloat16)
                bf16_ms = graph_ms(torch, lambda: act_ringconv.fused_act_ringconv(xb, None, None, k, bias,
                                                                                    apply_act=False))
        ops_ = 2 * 9 * C * Fo * Bs * Hs * Ws
        t_ops = ops_ / PEAK_INT8_OPS * 1e3
        w_bytes = nbytes(packed[0]) + nbytes(packed[1]) + Fo * 4
        t_bytes = (nbytes(xq) + w_bytes + nbytes(y)) / PEAK_BYTES * 1e3  # the conv: s8 xq in
        lane_bytes = (nbytes(x) + w_bytes + nbytes(y)) / PEAK_BYTES * 1e3  # the lane's function: x in
        mt = 2 if Ws >= 256 else 1  # launch_conv's m64 tiles per warpgroup
        per_site.append({
            "shape": list(shape), "x_dtype": str(x_dtype).split(".")[-1], "f": Fo, "per_forward": count,
            "ms": ms, "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "plain_ms": plain, "tops": ops_ / ms / 1e9,
            "m64_tiles": mt, **regs_of(f"w8a8_ringconv_kernel{mangled[out_dtype]}Li{mt}E"),
            "quantize_ms": q_ms, "quantize_bound_ms": (nbytes(x) + nbytes(xq)) / PEAK_BYTES * 1e3,
            "quantize_plain_ms": q_plain,
            **{f"quantize_{k_}": v for k_, v in regs_of(f"quantize_kernel{mangled[x_dtype]}Lb0E").items()},
            "lane_ms": lane_ms, "lane_bound_ms": max(lane_bytes, t_ops), "bf16_act_ringconv_ms": bf16_ms,
            "absmax_ms": absmax_ms, "absmax_bound_ms": nbytes(x) / PEAK_BYTES * 1e3,
            "absmax_plain_ms": absmax_plain, "absmax_library_ms": absmax_lib})
        print(f"int8 lane ok at {list(shape)} {str(x_dtype).split('.')[-1]} -> {Fo}: " + json.dumps(per_site[-1]))
    total = {key: sum(s[key] * s["per_forward"] for s in per_site)
             for key in ("ms", "bound_ms", "plain_ms", "quantize_ms", "quantize_bound_ms", "lane_ms",
                         "lane_bound_ms", "absmax_ms", "absmax_bound_ms")}
    total["lane_with_absmax_ms"] = total["lane_ms"] + total["absmax_ms"]
    bf16_sites = [s for s in per_site if s["bf16_act_ringconv_ms"] is not None]
    total["sites_with_a_bf16_kernel"] = sum(s["per_forward"] for s in bf16_sites)
    total["lane_ms_there"] = sum(s["lane_ms"] * s["per_forward"] for s in bf16_sites)
    total["bf16_act_ringconv_ms_there"] = sum(s["bf16_act_ringconv_ms"] * s["per_forward"] for s in bf16_sites)
    print(f"int8 lane per b{B} forward ({card}): " + json.dumps(total))

    # a NaN in x: the absmax keeps it, so the scale is NaN and every output,
    # on the card as from the plain version (and the JAX package)
    nan = {}
    for shape, x_dtype, Fo, out_dtype in (next(iter(unique)), max(unique, key=unique.get)):
        x = randn(torch, shape, 40, x_dtype)
        x[B - 1, shape[1] // 2, shape[2] // 3, shape[3] - 1] = float("nan")
        k = randn(torch, (3, 3, shape[3], Fo), 41, scale=0.05)
        with torch.inference_mode():
            y = quant.ring_conv_w8a8(x, k, None, out_dtype, quant.pack_weight(k))
            ref = quant.ring_conv_w8a8_plain(x, k, None, out_dtype)
        nan[f"{list(shape)} {str(x_dtype).split('.')[-1]}"] = {
            "absmax_nan": bool(torch.isnan(quant.act_absmax(x))), "all_nan": bool(torch.isnan(y).all()),
            "plain_all_nan": bool(torch.isnan(ref).all())}
    print(f"int8 lane, one NaN in x: {json.dumps(nan)}")
    if not all(all(v.values()) for v in nan.values()):
        raise AssertionError(f"int8 lane with a NaN in x: {nan}")

    # device time of a forward, both lanes, at b8 (CUDA graph) and b256 (events)
    times = {}
    with torch.inference_mode():
        for lane in (None, "w8a8"):
            layers.set_quant_conv(net, lane)
            try:
                times[f"b{B}_{lane or 'bf16'}_ms"] = graph_ms(torch, lambda: net(xin, cond), iters=3)
                xb = randn(torch, (256, H, W, 2), 32)
                cb = torch.linspace(-5.0, 5.0, 256, device="cuda")
                times[f"b256_{lane or 'bf16'}_ms"] = cuda_ms(torch, lambda: net(xb, cb), iters=2, warmup=1)
                del xb
            finally:
                layers.set_quant_conv(net, None)
    print(f"forward device time, int8 lane against bf16 ({card}): " + json.dumps(times))
    level1 = next(s for s in per_site if s["shape"][1:] == [H, W, 64] and s["f"] == 64 and s["x_dtype"] == "bfloat16")
    out.update({"sites": per_site, "per_forward": total, "forward_times": times, "level1": level1,
                "max_abs_err": worst, "absmax_max_abs_err": worst_absmax, "quantize_max_abs_err": worst_xq,
                "nan": nan})
    return out


REFINENET_FLAGS = ["--model.architecture", "refinenet", "--model.base_channels", "128",
                   "--model.channel_multiplier", "1,2,2,2"]


def phase_refinenet(torch, tmp, card):
    """The LiDARGen RefineNet at its published width (base 128, (1, 2, 2, 2),
    64x1024), random weights from seed 0: setup_model from a reference-layout
    .pth and from a msgpack, a b8 forward bf16 against fp32 on the card, a
    DDIM-16 b8 chain, ``generate`` (b2), ``train`` for 4 steps + 2 resumed at
    b8 on the synthetic set, and the ms of a forward and of a train step with
    their peak memory. It runs no hand-written kernel (plain PyTorch, as the
    JAX package has no Pallas kernel behind it): every counter reads 0."""
    import numpy as np

    from r2dm_tpu_torch import config as config_lib
    from r2dm_tpu_torch import ops, setup_model
    from r2dm_tpu_torch.checkpoint import load_checkpoint, write_checkpoint
    from r2dm_tpu_torch.diffusion import ContinuousTimeGaussianDiffusion
    from r2dm_tpu_torch.inference import build_model
    from r2dm_tpu_torch.models.refinenet import LiDARGenRefineNet, unit_grid
    from r2dm_tpu_torch.training import EMAConfig, init_train_state, make_optimizer, make_train_step
    from r2dm_tpu_torch.utils.weights import to_jax

    torch.backends.cudnn.allow_tf32 = False  # the fp32 reference forward in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config_lib.Config(model=config_lib.ModelConfig(architecture="refinenet", base_channels=128,
                                                         channel_multiplier=(1, 2, 2, 2)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net32 = build_model(cfg, device="cpu")
    sd = net32.state_dict()
    work = os.path.join(tmp, "refinenet")
    os.makedirs(work)
    pth = os.path.join(work, "refinenet-random.pth")
    torch.save({"cfg": config_lib.asdict(cfg), "weights": {f"model.{k}": v for k, v in sd.items()},
                "ema_weights": {**{f"ema_model.model.{k}": v for k, v in sd.items()},
                                "initted": torch.tensor(True), "step": torch.tensor(1)}, "global_step": 1}, pth)
    pack = write_checkpoint(os.path.join(work, "refinenet-random.msgpack"), config_lib.asdict(cfg),
                            to_jax(sd, "refinenet"), ema_weights=to_jax(sd, "refinenet"), step=1)
    out = {"parameters": sum(p.numel() for p in net32.parameters())}
    ops.reset_launch_counts()
    for path in (pth, pack):
        ddpm, lidar, cfg2 = setup_model(path, dtype=torch.bfloat16, device="cuda")
        got = ddpm.model.state_dict()
        same = all(torch.equal(got[k].cpu(), v) for k, v in sd.items()) and got.keys() == sd.keys()
        grid = np.allclose(lidar.ray_angles.cpu().numpy(), unit_grid(cfg.data.resolution)[0].transpose(1, 2, 0))
        if not (same and grid and isinstance(ddpm.model, LiDARGenRefineNet)):
            raise AssertionError(f"setup_model({os.path.basename(path)}): weights equal {same}, ray angles the "
                                 f"grid {grid}, {type(ddpm.model).__name__}")
    print(f"RefineNet {out['parameters']} parameters: setup_model from a reference .pth and a msgpack, weights "
          f"equal, ray angles its [0, 1] grid")

    # a b8 forward, bf16 against fp32 (TF32 off), and its ms
    net32 = net32.cuda().eval()
    net = ddpm.model
    H, W = cfg.data.resolution
    xin = randn(torch, (B, H, W, 2), 40)
    cond = torch.linspace(0.0, 1.0, B, device="cuda")
    # FLOPs of one forward: every conv's 2 x output pixels x weight size
    # (a multiply-add counts 2), read off the output shapes with hooks
    conv_flops = []
    hooks = [m.register_forward_hook(lambda m, a, y: conv_flops.append(2 * y[0, 0].numel() * m.weight.numel()))
             for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.inference_mode():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y16 = net(xin, cond)
        torch.cuda.synchronize()
        fwd_peak = torch.cuda.max_memory_allocated() - base
        for h in hooks:
            h.remove()
        y32 = net32(xin, cond)
        rel = ((y16 - y32).norm() / y32.norm()).item()
        fwd_ms = graph_ms(torch, lambda: net(xin, cond), iters=3)
        fwd32_ms = cuda_ms(torch, lambda: net32(xin, cond), iters=2, warmup=1)
    del net32, y32
    flops = sum(conv_flops) // B
    out["forward"] = {"rel_l2_bf16_vs_fp32": rel, "bf16_ms": fwd_ms, "fp32_ms": fwd32_ms, "peak_bytes": fwd_peak,
                      "conv_gflop_per_image": flops / 1e9, "bf16_tflops": flops * B / fwd_ms / 1e9}
    print(f"RefineNet forward b{B} ({card}): {json.dumps(out['forward'])} (limit 2e-2)")
    if not rel <= 2e-2:
        raise AssertionError(f"RefineNet bf16 against fp32: relative L2 {rel}")

    # DDIM-16 b8 and generate b2
    t0 = time.time()
    x = ddpm.sample(B, 16, mode="ddim", seeds=range(B))
    torch.cuda.synchronize()
    out["ddim16_s"] = time.time() - t0
    gen_dir = os.path.join(work, "generate")
    _run_cli("r2dm_tpu_torch.generate", ["--ckpt", pth, "--batch_size", "2", "--sampling_steps", "4", "--mode",
                                         "ddim", "--out_dir", gen_dir])
    size = _png_size(os.path.join(gen_dir, "samples_img.png"))
    print(f"RefineNet ddim16 b{B}: {out['ddim16_s']:.3f} s, max|x| {x.abs().max().item():.4f}; generate b2: "
          f"samples_img.png {size}")
    if not (bool(torch.isfinite(x).all()) and x.abs().max().item() <= 1.02 and size == (2 * 2 * H, W)):
        raise AssertionError(f"RefineNet sampling: finite {bool(torch.isfinite(x).all())}, PNG {size}")
    del ddpm, net

    # python -m r2dm_tpu_torch.train: 4 steps, then 2 resumed
    run_dir = os.path.join(work, "train")
    argv = REFINENET_FLAGS + ["--data.dataset", "synthetic", "--training.output_dir", run_dir,
                              "--training.steps_save_image", "100000", "--training.steps_save_model", "100000"]
    os.environ["R2DM_SYNTH_SCANS"] = str(B)
    try:
        t0 = time.time()
        _run_cli("r2dm_tpu_torch.train", argv + ["--training.num_steps", "4"])
        first = load_checkpoint(os.path.join(run_dir, "checkpoint.msgpack"))
        _run_cli("r2dm_tpu_torch.train", argv + ["--training.num_steps", "6", "--training.resume",
                                                 os.path.join(run_dir, "checkpoint.msgpack")])
        torch.cuda.synchronize()
        out["train_cli_s"] = time.time() - t0
    finally:
        os.environ.pop("R2DM_SYNTH_SCANS")
    second = load_checkpoint(os.path.join(run_dir, "checkpoint.msgpack"))
    counts = [(c["global_step"], int(c["opt_state"]["1"]["0"]["count"])) for c in (first, second)]
    finite = all(np.isfinite(np.asarray(a)).all() for a in _leaves(second["weights"]))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    print(f"RefineNet train b{B}, 4 + 2 resumed steps: {out['train_cli_s']:.3f} s, (step, AdamW count) {counts}, "
          f"losses logged {losses}, weights finite {finite}")
    if counts != [(4, 4), (6, 6)] or not finite or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"RefineNet train: {counts}, finite {finite}, losses {losses}")

    # the train step's ms and peak memory (CUDA events, 2 warm-up + 5 timed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        model = build_model(cfg, dtype=torch.bfloat16, device="cuda").train()
    optimizer, scheduler = make_optimizer(model.parameters(), config_lib.TrainingConfig(lr_warmup_steps=1))
    state = init_train_state(model, optimizer, scheduler)
    step = make_train_step(ContinuousTimeGaussianDiffusion(model), optimizer, scheduler,
                           EMAConfig(update_after_step=0, update_every=1))
    g = torch.Generator("cuda").manual_seed(3)
    x_0 = torch.rand((B, H, W, 2), generator=g, device="cuda") * 2 - 1
    for _ in range(2):
        step(state, x_0, g)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(state, x_0, g)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    med = sorted(step_ms)[len(step_ms) // 2]
    out["train_step"] = {"median_ms": med, "img_per_s": B / med * 1e3, "step_ms": step_ms,
                         "peak_bytes": torch.cuda.max_memory_allocated() - base, "resident_bytes": base,
                         "loss": metrics["loss"].item()}
    launches = _launches(ops)
    out["launches"] = launches
    print(f"RefineNet train step b{B} ({card}): {json.dumps(out['train_step'])}; hand-written kernel launches "
          f"over the phase {json.dumps(launches)}")
    if launches != launches_of(0, 0) or not math.isfinite(out["train_step"]["loss"]):
        raise AssertionError(f"RefineNet: launches {launches}, loss {out['train_step']['loss']}")
    return out


def int8_rows(int8, main_launches, train_launches) -> list:
    """The kernels line's rows of the int8 lane's three kernels, at the
    level-1 ResidualBlock site (64 -> 64 at 64x1024, b8): ``launches`` from
    the lane's main path, the DDIM-16 chain; the s8 conv's row is the conv
    alone on the quantize pass's output (its bound from s8 xq in; ``lane_ms``
    quantize + conv, beside the lane function's bound from bf16 x in). No
    single PyTorch call computes the int8 conv or the quantization
    (library_ms null); ``torch.linalg.vector_norm(x, inf)`` does the absmax."""
    lv = int8["level1"]
    shape = lv["shape"] + [lv["f"]]
    rows = []
    for name, ms, plain, bound, bound_by, lib, err in (
            ("ring_conv_w8a8", lv["ms"], lv["plain_ms"], lv["bound_ms"], lv["bound_by"], None, int8["max_abs_err"]),
            ("act_absmax", lv["absmax_ms"], lv["absmax_plain_ms"], lv["absmax_bound_ms"], "bytes",
             lv["absmax_library_ms"], int8["absmax_max_abs_err"]),
            ("act_quantize", lv["quantize_ms"], lv["quantize_plain_ms"], lv["quantize_bound_ms"], "bytes", None,
             int8["quantize_max_abs_err"])):
        src, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": int8["launches"][name], "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound, "bound_by": bound_by, "library_ms": lib, "shape": shape,
                     "main_path_launches": main_launches[name],
                     "train_launches_per_step": train_launches[name] // TRAIN_STEPS})
    rows[0].update({"lane_ms": lv["lane_ms"], "lane_bound_ms": lv["lane_bound_ms"], "tops": lv["tops"],
                    "bf16_act_ringconv_ms": lv["bf16_act_ringconv_ms"]})
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
    from r2dm_tpu_torch.bench import card as card_name

    card = card_name()
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
    width_kern = phases.run("width axis: the halo'd conv and the GN pair against their plain versions",
                            phase_width_kernels, torch, card)
    phases.run("conv∘FIR composed against two ops; the W2C record", phase_resample, torch)
    eval_out = accum = two_ranks = reflowed = int8 = width = width_train = validated = quality_out = None
    with tempfile.TemporaryDirectory() as tmp:
        main_out = phases.run("main path", phase_main, torch, tmp)
        if main_out is not None:
            phases.run("serving paths", phase_serving, torch, main_out, tmp)
            int8 = phases.run("int8 lane: the s8 ring conv, a forward, DDIM, generate, sample_and_save", phase_int8,
                              torch, main_out, tmp, card)
        refinenet = phases.run("RefineNet at full width: load, forward, sample, train", phase_refinenet, torch,
                               tmp, card)
        phases.run("training: backward of both kernels", phase_train_backward, torch)
        train_cli = phases.run("training: python -m r2dm_tpu_torch.train", phase_train_cli, torch, tmp)
        accum = phases.run("training: gradient accumulation", phase_accum_cli, torch, tmp)
        if main_out is not None:
            eval_out = phases.run("evaluation: sample_and_save, evaluate, completion_demo", phase_eval, torch,
                                  main_out, tmp, card)
            if eval_out is not None:
                phases.run("evaluation: extractor times, memory, precision", phase_eval_measure, torch, eval_out,
                           card)
                two_ranks = phases.run("data axis: two ranks on one card, one rank under NCCL", phase_two_ranks,
                                       torch, tmp, eval_out, card)
                width = phases.run(f"width axis: two ranks on one card, --mesh {WIDTH_MESH}", phase_width, torch,
                                   main_out, eval_out, tmp, card)
                validated = phases.run("python -m r2dm_tpu_torch.validate_pretrained", phase_validate, torch,
                                       main_out, eval_out, card)
            reflowed = phases.run("reflow", phase_reflow, torch, main_out, tmp, card)
        quality_out = phases.run("quality protocols: ddim_quality_check and flow_quality_check", phase_quality,
                                 torch, tmp, card)
        width_train = phases.run(f"width axis: training, two ranks on one card, --mesh {WIDTH_MESH}",
                                 phase_width_train, torch, tmp, card)
    step_out = phases.run("training: kernel path against plain path", phase_train_step, torch)
    train_time = bf16 = None
    if step_out is not None:
        ddpm = step_out.pop("ddpm")
        train_time = phases.run("training: step time and memory", phase_train_time, torch, ddpm)
        bf16 = phases.run("training: bf16 gradients", phase_grad_bf16, torch, ddpm)
        del ddpm
    if main_out is not None and gn_err is not None and conv_err is not None and train_cli is not None:
        errs = {**gn_err, "fused_act_ringconv": conv_err}
        rows = phases.run("timing", phase_time, torch, main_out["launches"], train_cli["launches"], errs)
        phases.run("breakdown", phase_breakdown, torch, main_out["ddpm"])
        if rows is not None and int8 is not None:
            rows += int8_rows(int8, main_out["launches"], train_cli["launches"])
        if rows is not None and width is not None and width_kern is not None:
            rows += width_rows(width, width_kern)
    else:
        rows = None
    if phases.failed:
        for line in phases.failed:
            log(f"FAILED {line}")
        return 1
    for row in rows:  # the other paths' own counts, each read right after its run
        name = row["name"]
        for path, counts in eval_out["launches"].items():
            row[f"{path}_launches"] = counts[name]
        row["accum_train_launches_per_micro_step"] = accum["launches_per_micro_step"][name]
        row["grad_bf16_step_launches"] = bf16["launches"][name]
        row["two_rank_train_launches_per_rank_per_step"] = two_ranks["train"]["launches_per_rank_per_step"][name]
        row["reflow_teacher_launches"] = reflowed["launches"]["teacher"][name]
        row["reflow_finetune_launches"] = reflowed["launches"]["finetune"][name]
        row["int8_ddim16_launches"] = int8["launches"][name]
        row["refinenet_phase_launches"] = refinenet["launches"][name]
        row["width_ddim4_launches_per_rank"] = width["launches"][name]
        row["width_int8_launches_per_rank"] = width["int8"]["forward_launches"][name]
        row["width_int8_ddim4_launches_per_rank"] = width["int8"]["ddim_launches"][name]
        row["width_train_launches_per_rank_per_step"] = width_train["launches_per_rank_per_step"][name]
        row["width_refinenet_launches_per_rank"] = width["refinenet"]["launches"][name]
        row["width_refinenet_train_launches_per_rank"] = width_train["refinenet"]["launches"][name]
        row["validate_pretrained_launches"] = validated["launches"][name]
        row["quality_ddim_launches"] = quality_out["ddim"]["launches"][name]
        row["quality_flow_launches"] = quality_out["flow"]["launches"][name]
    print(f"ddim16_b{B}_img_per_s {main_out['ddim16_img_s']:.4f}")
    print(f"int8_ddim16_b{B}_img_per_s {int8['ddim16']['img_per_s']:.4f}; int8 forward device ms "
          f"{json.dumps(int8['forward_times'])}")
    print(f"refinenet_b{B} forward {refinenet['forward']['bf16_ms']:.3f} ms, train step "
          f"{refinenet['train_step']['median_ms']:.3f} ms (peak {refinenet['train_step']['peak_bytes'] / 1e9:.3f} GB)")
    print(f"train_step_b{B}_median_ms {train_time['median_step_ms']:.3f} "
          f"({train_time['img_per_s']:.3f} img/s, peak {train_time['peak_bytes'] / 1e9:.3f} GB)")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
