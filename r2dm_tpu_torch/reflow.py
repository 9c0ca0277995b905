"""Reflow (2-rectification) of a trained rectified-flow checkpoint.

    python -m r2dm_tpu_torch.reflow --ckpt flow.msgpack --out reflowed.msgpack \\
        --num_pairs 4096 --teacher_steps 64 --train_steps 2000
    python -m r2dm_tpu_torch.reflow --device cpu ...   # on the CPU

The port of the repo's ``tools/reflow.py`` (arXiv 2209.03003 §3), with its
flags and defaults. Reflow fine-tunes the velocity on the model's own
(noise, sample) pairs, a deterministic coupling whose paths the next model
can make near-straight, for 1-2 step Euler sampling:

1. teacher pairs: for each chunk of ``--batch_size``, eps ~ N(0, I) from a
   generator seeded by (seed, chunk start), integrated by
   ``RectifiedFlow.sample_segment`` over ``linspace(1, 0, teacher_steps +
   1)`` to x_hat (under ``torch.no_grad``; the results are cloned out of
   the sampler's inference mode so that the fine-tune can read them); both
   stored in bfloat16 on the device;
2. fine-tune: AdamW(lr, betas (0.9, 0.99), weight decay 0), no clip, no
   schedule, no EMA; each step draws its minibatch indices and t ~ U(0, 1)
   on the device from a generator seeded by (seed + 1, step), and takes
   ``p_loss`` of the pairs with the PAIRED noise (the only change from
   first-round training is the coupling);
3. save the JAX package's checkpoint layout (same cfg) with EMA = the
   reflowed weights, which ``setup_model`` of either package loads.

On CUDA the network computes in bfloat16, the kernels' type: the teacher
runs both kernels forward, the fine-tune both forward and the ring conv's
input gradient backward. On the CPU it computes in float32, as the JAX tool.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import config as config_lib
from .checkpoint import write_checkpoint
from .diffusion.base import normal
from .diffusion.flow import RectifiedFlow
from .inference import setup_model
from .utils.weights import to_jax


def _generator(seed: int, index: int, device) -> torch.Generator:
    """A generator seeded from (seed, index) alone, as ``fold_in`` keys are."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state))


@torch.no_grad()
def teacher_pairs(flow: RectifiedFlow, eps: torch.Tensor, teacher_steps: int):
    """(eps, x_hat) in bfloat16: x_hat the teacher ODE from x(1) = eps to
    t = 0 in ``teacher_steps`` Euler steps."""
    ts = torch.linspace(1.0, 0.0, teacher_steps + 1, dtype=torch.float32, device=eps.device)
    x = flow.sample_segment(eps, ts).clone()  # a normal tensor, outside inference mode
    return eps.to(torch.bfloat16), x.to(torch.bfloat16)


def reflow_step(flow: RectifiedFlow, optimizer, x_data, eps_data, idx, t) -> torch.Tensor:
    """One AdamW step on the velocity loss of the pairs ``idx`` at times
    ``t``, with the paired noise; returns the loss."""
    x_pair = x_data[idx].to(torch.float32)
    eps_pair = eps_data[idx].to(torch.float32)
    loss = flow.p_loss(flow.model, x_pair, t, eps_pair)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="trained flow checkpoint")
    p.add_argument("--out", required=True, help="output checkpoint path")
    p.add_argument("--num_pairs", type=int, default=4096)
    p.add_argument("--teacher_steps", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--train_steps", type=int, default=2000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    ddpm, _, cfg = setup_model(args.ckpt, dtype=torch.bfloat16 if device.type == "cuda" else None, device=device)
    flow = ddpm.diffusion
    if not isinstance(flow, RectifiedFlow):
        raise SystemExit("reflow requires a flow checkpoint (--diffusion.timestep_type flow)")
    model = flow.model

    # ---- 1. teacher pairs (eps, x_hat), per-chunk deterministic -----------
    eps_parts, x_parts = [], []
    for i in range(0, args.num_pairs, args.batch_size):
        eps = normal(_generator(args.seed, i, device), (args.batch_size, *flow.sampling_shape), device)
        eps, x = teacher_pairs(flow, eps, args.teacher_steps)
        eps_parts.append(eps)
        x_parts.append(x)
        print(f"pairs [{min(i + args.batch_size, args.num_pairs)}/{args.num_pairs}]", flush=True)
    eps_all = torch.cat(eps_parts)[:args.num_pairs]
    x_all = torch.cat(x_parts)[:args.num_pairs]
    del eps_parts, x_parts

    # ---- 2. fine-tune the velocity on the deterministic coupling ---------
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.0)
    for step in range(args.train_steps):
        g = _generator(args.seed + 1, step, device)
        idx = torch.randint(0, x_all.shape[0], (args.batch_size,), generator=g, device=device)
        t = torch.rand((args.batch_size,), generator=g, device=device)
        loss = reflow_step(flow, optimizer, x_all, eps_all, idx, t)
        if step % 50 == 0 or step == args.train_steps - 1:
            print(f"reflow step {step}: loss {float(loss):.2e}", flush=True)

    # ---- 3. save (the JAX layout; EMA lane = the reflowed weights) -------
    weights = to_jax(model.state_dict(), model.architecture)
    write_checkpoint(args.out, config_lib.asdict(cfg), weights, ema_weights=weights, step=args.train_steps)
    print(f"wrote {args.out} — sample with --mode euler and 1-4 steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
