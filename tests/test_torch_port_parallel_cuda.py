"""Card-only tests of the data axis and the bf16-gradient step: a one-rank
NCCL group (the default backend on CUDA) with a DDP-wrapped config-H
ResidualBlock whose gradients equal the unwrapped block's, and the
``grad_bf16`` train step through both kernels with their launch counts,
against the plain path.

They skip without a CUDA device. This file imports no JAX, so on a machine
with the card and without JAX it runs as
``python -m pytest --noconftest -m cuda tests/test_torch_port_parallel_cuda.py``.
"""

import copy
import datetime

import pytest
import torch
import torch.distributed as dist

from r2dm_tpu_torch import config as config_lib
from r2dm_tpu_torch import ops, parallel
from r2dm_tpu_torch.bench import random_ddpm
from r2dm_tpu_torch.models import layers
from r2dm_tpu_torch.training import EMAConfig, init_train_state, make_optimizer, make_train_step

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda
TRAIN_REL_L2 = 2e-2  # kernel path against plain path, as chip_smoke.py


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dev, seed, dtype=torch.float32):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def test_one_rank_nccl_ddp_residual_block_gradients_equal_the_plain_block(dev, tmp_path):
    """The block at config-H level 1 (64 -> 64 channels, 64x1024, b2): DDP
    over a one-rank NCCL group averages over one rank, so every gradient is
    the unwrapped block's, bit for bit; parallel.init takes the group as it
    stands."""
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        world = parallel.init("cuda")
        assert (world.rank, world.size, world.distributed, world.owns_group) == (0, 1, True, False)
        assert dist.get_backend() == "nccl" and world.device == torch.device("cuda", 0)
        assert parallel.any_rank(world, True) and parallel.gather_objects(world, "x") == ["x"]
        torch.manual_seed(0)
        block = layers.ResidualBlock(64, 64, 256, 8, 1e-6, dtype=torch.bfloat16).to(dev)
        with torch.no_grad():
            for p in block.parameters():
                p.copy_(_randn(p.shape, dev, 1) * 0.05)
        plain = copy.deepcopy(block)
        ddp = torch.nn.parallel.DistributedDataParallel(block, device_ids=[0])
        x = _randn((2, 64, 1024, 64), dev, 2, torch.bfloat16)
        emb = _randn((2, 256), dev, 3)
        dy = _randn((2, 64, 1024, 64), dev, 4, torch.bfloat16)
        ops.reset_launch_counts()
        ddp(x, emb).backward(dy)
        plain(x, emb).backward(dy)
        assert {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS} == {
            "fused_group_norm_silu": 4, "fused_act_ringconv": 8,  # 2 GN and 2 + 2 conv a block
            "ring_conv_w8a8": 0, "act_absmax": 0, "act_quantize": 0, "act_ringconv_halo": 0, "gn_stats": 0,
            "gn_apply": 0,
            "act_quantize_halo": 0}
        for (name, p), q in zip(block.named_parameters(), plain.parameters()):
            assert p.grad is not None and torch.equal(p.grad, q.grad), name
    finally:
        dist.destroy_process_group()


def test_grad_bf16_step_runs_both_kernels(dev):
    """One config-H b8 train step with bf16 gradients: 50 GN + 96 conv
    launches (the bf16 copy of the parameters still reaches both kernels,
    GroupNorm with bf16 gain and shift), and the kernel path's gradient
    within relative L2 2e-2 of the plain path's at the same weights, batch,
    steps and noise."""
    ddpm = random_ddpm(seed=1)
    model, diffusion = ddpm.model.train(), ddpm.diffusion
    g = torch.Generator("cuda").manual_seed(2)
    x_0 = torch.rand((8, 64, 1024, 2), generator=g, device="cuda") * 2 - 1
    steps = torch.rand((8,), generator=g, device="cuda")
    noise = torch.randn((8, 64, 1024, 2), generator=g, device="cuda")
    cfg = config_lib.TrainingConfig(grad_bf16=True, lr=0.0, lr_warmup_steps=0)

    def grads_of_one_step():
        m = copy.deepcopy(model)
        optimizer, scheduler = make_optimizer(m.parameters(), cfg)
        state = init_train_state(m, optimizer, scheduler)
        step = make_train_step(diffusion, optimizer, scheduler, EMAConfig(), grad_dtype=torch.bfloat16)
        ops.reset_launch_counts()
        metrics = step(state, x_0, steps=steps, noise=noise)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
        return metrics, launches, [p.grad for p in m.parameters()]

    metrics, launches, grads = grads_of_one_step()
    assert launches == {"fused_group_norm_silu": 50, "fused_act_ringconv": 96, "ring_conv_w8a8": 0,
                        "act_absmax": 0, "act_quantize": 0, "act_ringconv_halo": 0, "gn_stats": 0, "gn_apply": 0,
                        "act_quantize_halo": 0}
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    saved = {n: getattr(layers, n) for n in ("fused_group_norm_silu", "fused_act_ringconv")}
    try:
        layers.fused_group_norm_silu = ops.gn_silu.fused_group_norm_silu_plain
        layers.fused_act_ringconv = ops.act_ringconv.act_ringconv_plain
        _, plain_launches, plain_grads = grads_of_one_step()
    finally:
        for n, fn in saved.items():
            setattr(layers, n, fn)
    assert plain_launches == {"fused_group_norm_silu": 0, "fused_act_ringconv": 0, "ring_conv_w8a8": 0,
                              "act_absmax": 0, "act_quantize": 0, "act_ringconv_halo": 0, "gn_stats": 0, "gn_apply": 0,
                              "act_quantize_halo": 0}
    flat, flat_plain = (torch.cat([gr.flatten() for gr in gs]) for gs in (grads, plain_grads))
    rel = ((flat - flat_plain).norm() / flat_plain.norm()).item()
    assert rel <= TRAIN_REL_L2, rel
