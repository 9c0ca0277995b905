"""Faults planted in the program underneath a run, for the correctness
check's own tests and for reading a fault's numbers on the card
(``calibrate.py --fault``). Each is a context manager that patches one of
the program's callables and puts it back.

- ``unchanged_state``: a sampler step returns its input; a train step's
  AdamW update does nothing;
- ``half_batch``: the network (the port's class of the configuration's
  architecture) runs on the first half of the rows and the rest get their
  mean; the training loss is the mean over the first half;
- ``altered_answer``: a scan's depth moved by half a metre after the
  conversion to points (closed loop), one row of a step's output moved by 0.1
  (chain), one leaf's clipped gradient scaled by 1.5 (training).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from . import manifest

FAULTS = ("unchanged_state", "half_batch", "altered_answer")


@contextmanager
def _patched(owner, name: str, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _half_rows(original):
    def forward(self, images, timesteps, generator=None):
        half = max(1, images.shape[0] // 2)
        out = original(self, images[:half], timesteps[:half], generator)
        return torch.cat([out, out.mean(0, keepdim=True).expand(images.shape[0] - half, *out.shape[1:])])

    return forward


def _step_moved(original):
    def p_step(self, x_t, *args, **kwargs):
        out = original(self, x_t, *args, **kwargs).clone()
        out[-1] += 0.1
        return out

    return p_step


def _same_state(original):
    def p_step(self, x_t, *args, **kwargs):
        original(self, x_t, *args, **kwargs)
        return x_t.to(torch.float32)

    return p_step


def _depth_moved(original):
    def postprocess(x, lidar_utils):
        out = original(x, lidar_utils).clone()
        out[0, 0] += 0.5
        return out

    return postprocess


def _half_loss(original):
    def masked_weighted_loss(loss, loss_mask, weight, width=None):
        half = max(1, loss.shape[0] // 2)
        return original(loss[:half], None if loss_mask is None else loss_mask[:half], weight[:half], width)

    return masked_weighted_loss


def _gradient_scaled(original):
    def clip_grad_norm_(params, *args, **kwargs):
        params = list(params)
        norm = original(params, *args, **kwargs)
        params[0].grad.mul_(1.5)
        return norm

    return clip_grad_norm_


def plant(fault: str, ctx):
    """The context manager that plants ``fault`` under the timed path of the
    run ``ctx`` describes: its driver's, on its configuration's network."""
    import r2dm_tpu_torch.diffusion.base as base
    import r2dm_tpu_torch.sample_and_save as sas
    from r2dm_tpu_torch.diffusion.continuous import ContinuousTimeGaussianDiffusion

    driver = ctx.traffic["driver"]
    if driver == "train":
        return {
            "unchanged_state": lambda: _patched(torch.optim.AdamW, "step", lambda original: lambda self, closure=None: None),
            "half_batch": lambda: _patched(base, "masked_weighted_loss", _half_loss),
            "altered_answer": lambda: _patched(torch.nn.utils, "clip_grad_norm_", _gradient_scaled),
        }[fault]()
    if fault == "unchanged_state":
        return _patched(ContinuousTimeGaussianDiffusion, "p_step", _same_state)
    if fault == "half_batch":
        return _patched(manifest.architecture(ctx.cfg).program_net(), "forward", _half_rows)
    if driver == "closed_loop":
        return _patched(sas, "postprocess", _depth_moved)
    return _patched(ContinuousTimeGaussianDiffusion, "p_step", _step_moved)
