"""The train step: loss, backward, clip, AdamW, LR schedule, EMA.

The port of ``r2dm_tpu/training/step.py`` (reference hot loop, train.py:
259-310). The JAX package compiles the step into one XLA program and returns
a new state; here it runs eagerly and updates ``TrainState`` in place. On a
CUDA model every forward runs both hand-written kernels and every backward
the ring-conv kernel again (its input gradient; ``ops/act_ringconv.py``).

Gradient accumulation is optax ``MultiSteps(tx, k)`` (r2dm_tpu/training/
optim.py:55-56) as the JAX trainer drives it (train.py:279-302): each call
is one micro-step on one batch; the gradient enters optax's running mean
``acc + (g - acc) / (mini_step + 1)``; every k-th call the clip and AdamW
run on that mean, the mean goes back to zero and the scheduler advances;
on the other calls the parameters do not move. ``state.step`` counts calls
(micro-steps), as the JAX ``state.step`` does, and the EMA moves on every
call with that count; ``state.updates`` counts AdamW updates, the count
AdamW and the schedule see. The logged ``grad_norm`` is the norm of the
call's own gradient, as JAX logs ``global_norm(grads)``.

``grad_dtype`` is the JAX step's low-precision-cotangent policy
(r2dm_tpu/training/step.py:82-94): the loss runs on a copy of the float
parameters cast to ``grad_dtype`` (``torch.func.functional_call``), so
the whole backward and the gradients are in that type, and the gradients
are cast to the fp32 masters' ``.grad`` only for the update. The copy
rounds every parameter as JAX's cast does, GroupNorm's gain and shift
included (the model's own forward hands them to the kernel in fp32).

Under a width axis (``width``: a ``World`` whose width group splits each
image's columns, the model ``set_width_shard`` on it) each rank's loss and
backward give its columns' share of every parameter gradient; DDP, which
averages over every rank, would divide those shares by D·W. So the step
sums the gradients over the whole world in one flat all-reduce and divides
by the data size D: the width sum of the shares, then the data mean (the
``grad_bf16`` path's all-reduce, in the gradients' dtype). It runs on every
call, accumulating or not, and before the clip, so every rank clips the
same gradient.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..utils import trace
from .ema import EMAConfig, ema_update
from .optim import CLIP_NORM


@dataclass
class TrainState:
    model: torch.nn.Module  # fp32 parameters, in training mode
    ema_model: torch.nn.Module  # the EMA parameters, as a copy of the model in eval mode
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0  # train-step calls: micro-steps under accumulation (the JAX state.step)
    accumulation_steps: int = 1  # k of optax MultiSteps
    updates: int = 0  # AdamW updates done (optax's count; MultiSteps' gradient_step)
    mini_step: int = 0  # micro-steps in the running mean (MultiSteps' mini_step)
    acc_grads: Optional[list] = None  # that running mean, one fp32 tensor a parameter (k > 1)


def init_train_state(model: torch.nn.Module, optimizer, scheduler, accumulation_steps: int = 1) -> TrainState:
    """The model set to training mode, and its EMA copy starting equal to it;
    with ``accumulation_steps`` k > 1 a zero running mean of the gradients."""
    if accumulation_steps < 1:
        raise ValueError(f"accumulation_steps must be >= 1, got {accumulation_steps}")
    ema_model = copy.deepcopy(model).eval().requires_grad_(False)
    acc = [torch.zeros_like(p) for p in model.parameters()] if accumulation_steps > 1 else None
    return TrainState(model.train(), ema_model, optimizer, scheduler, 0, accumulation_steps, 0, 0, acc)


def _all_reduce_mean(grads: list, group, divisor: int) -> list:
    """``grads`` summed over ``group`` in one flat all-reduce and divided by
    ``divisor``, in their dtype; the pieces of the flat tensor, in order."""
    flat = torch.cat([g.reshape(-1) for g in grads]).div_(divisor)
    dist.all_reduce(flat, group=group)
    return [t.view(g.shape) for t, g in zip(flat.split([g.numel() for g in grads]), grads)]


def make_train_step(diffusion, optimizer, scheduler, ema_cfg: EMAConfig, grad_dtype: Optional[torch.dtype] = None,
                    ddp: Optional[torch.nn.Module] = None, width=None):
    """``train_step(state, x_0, generator, loss_mask=None, steps=None,
    noise=None) -> {loss, grad_norm, ema_decay}``.

    Draws the timesteps, the noise and the dropout masks from ``generator``
    in that order, unless ``steps`` and ``noise`` are given (the tests hand
    both frameworks the same numbers; the data-parallel trainer hands each
    rank its rows of the global batch's draws). Then backward, and every
    ``state.accumulation_steps``-th call the global-norm clip at 1.0, AdamW
    and the scheduler; the EMA after every call, counting calls from step 0
    as the reference does (train.py:270-276). The metrics are the
    reference's logged scalars (train.py:273-277): the loss and the call's
    pre-clip gradient norm as 0-d tensors on the model's device (no host
    sync), and the EMA decay as a float.

    ``ddp``: the ``DistributedDataParallel`` wrapper of ``state.model``; the
    forward goes through it, so its hooks average the gradients over the
    ranks on every call (accumulation does not skip the all-reduce). Under
    ``grad_dtype`` the loss runs on the low-precision copy, which DDP's
    hooks never see: those gradients are averaged over ``ddp.process_group``
    explicitly, in ``grad_dtype``, as XLA's psum sums the JAX step's bf16
    gradient tree.

    ``width``: the ``World`` of a width axis over more than one rank (the
    module docstring), in place of ``ddp``: the gradients are summed over
    the world and divided by its data size after every backward."""
    if ddp is not None and width is not None:
        raise ValueError("a width axis sums the gradients itself: pass ddp or width, not both")

    def loss_of(net, x_0, generator, loss_mask, steps, noise):
        model_kwargs = {"generator": generator}
        if steps is None:
            return diffusion.loss(net, x_0, generator, loss_mask, model_kwargs)
        return diffusion.p_loss(net, x_0, steps, noise, loss_mask, model_kwargs)

    def low_precision_backward(state: TrainState, *args) -> torch.Tensor:
        named = list(state.model.named_parameters())
        with trace.span("train.loss"):
            cast = {n: p.detach().to(grad_dtype).requires_grad_() for n, p in named}

            def net(x, cond, **kwargs):
                return torch.func.functional_call(state.model, cast, (x, cond), kwargs)

            loss = loss_of(net, *args)
        with trace.span("train.backward"):
            grads = torch.autograd.grad(loss, list(cast.values()))
            if ddp is not None:
                grads = _all_reduce_mean(grads, ddp.process_group, dist.get_world_size(ddp.process_group))
            elif width is not None:
                grads = _all_reduce_mean(grads, None, width.data_size)
            for (_, p), g in zip(named, grads):
                p.grad = g.reshape(p.shape).to(p.dtype)
        return loss

    def width_reduce(state: TrainState) -> None:
        """The width axis's reduction of the gradients, in place (every rank
        runs the same network, so every rank has gradients of the same
        parameters)."""
        params = [p for p in state.model.parameters() if p.grad is not None]
        for p, g in zip(params, _all_reduce_mean([p.grad for p in params], None, width.data_size)):
            p.grad = g

    def accumulate(state: TrainState, params: list) -> torch.Tensor:
        """optax MultiSteps.update: the running mean, and on the k-th call
        the inner update on it."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        grad_norm = torch.nn.utils.get_total_norm(grads)
        n = state.mini_step
        for acc, g in zip(state.acc_grads, grads):
            acc.add_(g.sub(acc).div_(n + 1))
        if n == state.accumulation_steps - 1:
            for p, acc in zip(params, state.acc_grads):
                p.grad = acc.clone()
            torch.nn.utils.clip_grad_norm_(params, CLIP_NORM)
            optimizer.step()
            scheduler.step()
            state.updates += 1
            for acc in state.acc_grads:
                acc.zero_()
        state.mini_step = (n + 1) % state.accumulation_steps
        return grad_norm

    def train_step(
        state: TrainState, x_0: torch.Tensor, generator: Optional[torch.Generator] = None,
        loss_mask: Optional[torch.Tensor] = None, steps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> dict:
        args = (x_0, generator, loss_mask, steps, noise)
        with trace.span("train.step", device=x_0):
            optimizer.zero_grad(set_to_none=True)
            if grad_dtype is None:
                with trace.span("train.loss"):
                    loss = loss_of(ddp if ddp is not None else state.model, *args)
                with trace.span("train.backward"):
                    loss.backward()
                    if width is not None:
                        width_reduce(state)
            else:
                loss = low_precision_backward(state, *args)
            with trace.span("train.update"):
                if state.accumulation_steps == 1:
                    params = [p for p in state.model.parameters() if p.grad is not None]
                    grad_norm = torch.nn.utils.clip_grad_norm_(params, CLIP_NORM)
                    optimizer.step()
                    scheduler.step()
                    state.updates += 1
                else:
                    grad_norm = accumulate(state, list(state.model.parameters()))
                decay = ema_update(state.ema_model.parameters(), state.model.parameters(), state.step, ema_cfg)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm, "ema_decay": decay}

    return train_step
