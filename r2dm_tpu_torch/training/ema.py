"""Exponential moving average of the parameters (``r2dm_tpu/training/ema.py``).

The training dynamics of the reference's ``ema_pytorch.EMA`` (train.py:
134-142; beta = cfg.ema_decay, update_every = 10, warmup ramp): the decay
ramps as 1 - (1 + epoch / inv_gamma)^(-power), clamped to [min_value,
beta], where epoch = step - update_after_step - 1; the average copies the
parameters (decay 0) until then, and moves only every ``update_every``
steps. The decay is computed in float32, as the JAX package does.

Unlike the JAX package's pure tree map, the average is updated in place
with ``torch._foreach_mul_`` / ``torch._foreach_add_``, e * d + p * (1 - d):
one pass over the parameters and no second copy of them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class EMAConfig(NamedTuple):
    beta: float = 0.995
    update_every: int = 10
    update_after_step: int = 100
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0
    min_value: float = 0.0


def ema_decay(step: int, cfg: EMAConfig) -> float:
    """The decay at ``step`` (0 while copying), in float32 arithmetic."""
    f32 = np.float32
    epoch = max(f32(step) - f32(cfg.update_after_step) - f32(1.0), f32(0.0))
    value = f32(1.0) - (f32(1.0) + epoch / f32(cfg.inv_gamma)) ** f32(-cfg.power)
    value = min(max(value, f32(cfg.min_value)), f32(cfg.beta))
    return 0.0 if epoch <= 0.0 else float(value)


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor], params: Sequence[torch.Tensor], step: int, cfg: EMAConfig) -> float:
    """Move ``ema_params`` toward ``params`` in place and return the decay.

    ``step`` counts update calls from 0, one per train step, as the
    reference does; a step that is not a multiple of ``update_every`` leaves
    the average as it is (the JAX package's decay of 1)."""
    decay = ema_decay(step, cfg)
    if step % cfg.update_every == 0:
        ema_params, params = list(ema_params), [p.detach() for p in params]
        torch._foreach_mul_(ema_params, decay)
        torch._foreach_add_(ema_params, params, alpha=float(np.float32(1.0) - np.float32(decay)))
    return decay
