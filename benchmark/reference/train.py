"""R2DM's training recipe in plain float32 (kazuto1011/r2dm ``train.py``,
``utils/training.py``, ``ema_pytorch``): the loss of ``diffusion.py``, its
gradient, the global-norm clip at 1.0 (scale max / (norm + 1e-6) when the
norm is above it), AdamW (lr 1e-4, betas (0.9, 0.99), eps 1e-8, weight decay
0) under the cosine schedule with a linear warm-up, and the EMA (beta 0.995,
every 10 steps, decay 1 - (1 + step - 101)^(-2/3) clamped to [0, beta], a
copy before step 101).

``RefTrainer.step`` takes the batch, the timesteps and the noise, and
computes the gradient in blocks of rows (the loss is a mean of per-sample
terms, so the blocks' gradients add up), so that an fp32 step at the timed
batch fits beside nothing else on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .diffusion import per_sample_loss

CLIP_NORM = 1.0
LR, BETA1, BETA2, ADAM_EPS = 1e-4, 0.9, 0.99, 1e-8
EMA_BETA, EMA_EVERY, EMA_AFTER, EMA_POWER = 0.995, 10, 100, 2.0 / 3.0


def lr_at(update: int, warmup: int, total: int) -> float:
    if update < warmup:
        return LR * update / max(1, warmup)
    progress = (update - warmup) / max(1, total - warmup)
    return LR * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))


def ema_decay(step: int) -> float:
    f32 = np.float32
    epoch = max(f32(step) - f32(EMA_AFTER) - f32(1.0), f32(0.0))
    value = min(max(f32(1.0) - (f32(1.0) + epoch) ** f32(-EMA_POWER), f32(0.0)), f32(EMA_BETA))
    return 0.0 if epoch <= 0.0 else float(value)


class RefTrainer:
    def __init__(self, net: torch.nn.Module, first_update: int, warmup: int, total: int):
        self.net = net.train()
        self.params = [p for p in net.parameters()]
        self.names = [n for n, _ in net.named_parameters()]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.ema = [p.detach().clone() for p in self.params]
        self.update, self.warmup, self.total, self.t = first_update, warmup, total, 0

    def step(self, x_0, t, noise, rows_per_block: int) -> dict:
        """One train step; returns the loss, the clipped gradient and the
        norm before the clip."""
        B = x_0.shape[0]
        for p in self.params:
            p.grad = None
        loss = 0.0
        for lo in range(0, B, rows_per_block):
            hi = min(lo + rows_per_block, B)
            part = per_sample_loss(self.net, x_0[lo:hi], t[lo:hi], noise[lo:hi]).sum() / B
            part.backward()
            loss += float(part.detach())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)).item()
        coef = min(1.0, CLIP_NORM / (norm + 1e-6))
        grads = [g * coef for g in grads]
        lr = lr_at(self.update, self.warmup, self.total)
        self.t += 1
        bc1, bc2 = 1.0 - BETA1 ** self.t, 1.0 - BETA2 ** self.t
        with torch.no_grad():
            for p, g, m, v in zip(self.params, grads, self.m, self.v):
                m.mul_(BETA1).add_(g, alpha=1.0 - BETA1)
                v.mul_(BETA2).add_(g * g, alpha=1.0 - BETA2)
                p.sub_(lr / bc1 * m / (torch.sqrt(v / bc2) + ADAM_EPS))
        self.update += 1
        return {"loss": loss, "grads": grads, "norm": norm}

    def ema_update(self, step_index: int) -> None:
        if step_index % EMA_EVERY:
            return
        d = ema_decay(step_index)
        with torch.no_grad():
            for e, p in zip(self.ema, self.params):
                e.mul_(d).add_(p.detach(), alpha=1.0 - d)
