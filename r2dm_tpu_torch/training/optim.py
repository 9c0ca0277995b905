"""Optimiser and LR schedule of the reference training recipe.

Reference: AdamW (lr 1e-4, betas (0.9, 0.99), weight decay 0, eps 1e-8),
global-norm gradient clip 1.0 and a cosine-with-warmup LambdaLR
(train.py:157-163, 185-191, 267-268; utils/training.py:7-24). The JAX
package writes it as one optax chain (``r2dm_tpu/training/optim.py``); here
it is ``torch.optim.AdamW`` with a ``LambdaLR`` of the same lambda, and the
clip is ``torch.nn.utils.clip_grad_norm_`` in the train step.

Where the two differ:
- optax evaluates the schedule at its update count before incrementing it,
  so the first update uses lr(0) (0 with warmup). ``LambdaLR`` sets lr(0)
  when it is built and the train step advances it after each update: the
  same lrs at the same updates.
- optax's clip scales by max_norm / norm, ``clip_grad_norm_`` by
  max_norm / (norm + 1e-6): a relative difference of 1e-6 / norm on a
  clipped step.
"""

from __future__ import annotations

import math

import torch

from ..config import TrainingConfig

CLIP_NORM = 1.0  # reference train.py:267


def cosine_schedule_with_warmup(num_warmup_steps: int, num_training_steps: int, num_cycles: float = 0.5):
    """The reference lr_lambda (utils/training.py:14-22): the factor on the
    base lr at ``step``."""

    def lr_lambda(step: int) -> float:
        if step < num_warmup_steps:
            return float(step) / float(max(1, num_warmup_steps))
        progress = float(step - num_warmup_steps) / float(max(1, num_training_steps - num_warmup_steps))
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * float(num_cycles) * 2.0 * progress)))

    return lr_lambda


def make_optimizer(params, cfg: TrainingConfig):
    """(AdamW, LambdaLR) for ``params``. Gradient accumulation (optax
    ``MultiSteps``) lives in the train step (``training/step.py``), which
    steps both every ``gradient_accumulation_steps`` calls. ``grad_bf16``
    needs a bf16 network, as the JAX trainer requires (train.py:286-290)."""
    if cfg.grad_bf16 and cfg.mixed_precision != "bf16":
        raise ValueError(
            "training.grad_bf16 requires mixed_precision='bf16': with fp32 "
            "compute the bf16-cast params would dtype-mismatch the convs"
        )
    optimizer = torch.optim.AdamW(
        params, lr=cfg.lr, betas=(cfg.adam_beta1, cfg.adam_beta2),
        eps=cfg.adam_epsilon, weight_decay=cfg.adam_weight_decay,
    )
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, cosine_schedule_with_warmup(cfg.lr_warmup_steps, cfg.num_steps)
    )
    return optimizer, scheduler


def schedule_lr(scheduler, step: int) -> float:
    """The schedule's lr at ``step``: what the JAX trainer logs as
    ``lr_schedule(global_step)`` (train.py:390), at the micro-step count."""
    return scheduler.base_lrs[0] * scheduler.lr_lambdas[0](step)


def set_schedule_step(scheduler, step: int) -> None:
    """Put ``scheduler`` (and its optimiser's lr) at ``step`` updates done:
    the next update uses lr(step), as a resumed optax schedule does."""
    scheduler.last_epoch = step
    lrs = [base * fn(step) for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(scheduler.optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs
