"""The train step: loss, backward, clip, AdamW, LR schedule, EMA.

The port of ``r2dm_tpu/training/step.py`` (reference hot loop, train.py:
259-310). The JAX package compiles the step into one XLA program and returns
a new state; here it runs eagerly and updates ``TrainState`` in place. On a
CUDA model every forward runs both hand-written kernels and every backward
the ring-conv kernel again (its input gradient; ``ops/act_ringconv.py``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch

from .ema import EMAConfig, ema_update
from .optim import CLIP_NORM


@dataclass
class TrainState:
    model: torch.nn.Module  # fp32 parameters, in training mode
    ema_model: torch.nn.Module  # the EMA parameters, as a copy of the model in eval mode
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0  # updates done


def init_train_state(model: torch.nn.Module, optimizer, scheduler) -> TrainState:
    """The model set to training mode, and its EMA copy starting equal to it."""
    ema_model = copy.deepcopy(model).eval().requires_grad_(False)
    return TrainState(model.train(), ema_model, optimizer, scheduler, 0)


def make_train_step(diffusion, optimizer, scheduler, ema_cfg: EMAConfig):
    """``train_step(state, x_0, generator, loss_mask=None, steps=None,
    noise=None) -> {loss, grad_norm, ema_decay}``.

    Draws the timesteps, the noise and the dropout masks from ``generator``
    in that order, unless ``steps`` and ``noise`` are given (the tests hand
    both frameworks the same numbers). Then backward, the global-norm clip
    at 1.0, AdamW, the scheduler, and the EMA after the update, counting its
    calls from step 0 as the reference does (train.py:270-276). The metrics
    are the reference's logged scalars (train.py:273-277): the loss and the
    pre-clip gradient norm as 0-d tensors on the model's device (no host
    sync), and the EMA decay as a float."""

    def train_step(
        state: TrainState, x_0: torch.Tensor, generator: Optional[torch.Generator] = None,
        loss_mask: Optional[torch.Tensor] = None, steps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> dict:
        model_kwargs = {"generator": generator}
        if steps is None:
            loss = diffusion.loss(state.model, x_0, generator, loss_mask, model_kwargs)
        else:
            loss = diffusion.p_loss(state.model, x_0, steps, noise, loss_mask, model_kwargs)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for p in state.model.parameters() if p.grad is not None]
        grad_norm = torch.nn.utils.clip_grad_norm_(params, CLIP_NORM)
        optimizer.step()
        scheduler.step()
        decay = ema_update(state.ema_model.parameters(), state.model.parameters(), state.step, ema_cfg)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm, "ema_decay": decay}

    return train_step
