"""Rectified flow / flow matching on straight noise -> data paths.

Port of ``r2dm_tpu/diffusion/flow.py`` (arXiv 2209.03003, 2210.02747; the
reference authors' few-step follow-up, arXiv 2412.02241):

  path      x_t = (1 - t) x_0 + t eps,        t in [0, 1]
  training  minimise || v_theta(x_t, t) - (eps - x_0) ||^2
  sampling  integrate dx/dt = v_theta(x, t) from x(1) = eps to t = 0
            ("euler": one network call a step, "midpoint": two)

The network conditions on ``t * condition_scale`` (default 1000). The same
hooks as the Gaussian processes (``q_step``, ``_repaint_reverse_jumps``)
let the RePaint loops of ``base.py`` run it; its reverse jumps are
deterministic Euler steps, so they draw the known-pixel noise only.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import trace
from .base import Draw, GaussianDiffusion, Generators, OnSegment, _b, stack_steps


class RectifiedFlow(GaussianDiffusion):
    """Velocity matching on straight paths (see the module docstring)."""

    def __init__(
        self,
        model,
        loss_type: str = "l2",
        sampling_resolution: Optional[tuple[int, int]] = None,
        condition_scale: float = 1000.0,
    ):
        super().__init__(
            model=model,
            prediction_type="v",
            loss_type=loss_type,
            num_training_steps=None,
            noise_schedule="linear",
            min_snr_loss_weight=False,
            sampling_resolution=sampling_resolution,
            clip_sample=False,  # the ODE is integrated unclipped
        )
        self.condition_scale = float(condition_scale)

    # training hooks ---------------------------------------------------------
    def sample_timesteps(self, batch_size: int, generator: Generators = None, device=None) -> torch.Tensor:
        return torch.rand((batch_size,), generator=generator, device=self._device(device))

    def get_network_condition(self, steps: torch.Tensor) -> torch.Tensor:
        return torch.atleast_1d(steps).to(torch.float32) * self.condition_scale

    def get_target(self, x_0, steps, noise):
        return noise - x_0  # the straight path's constant velocity

    def get_loss_weight(self, steps) -> torch.Tensor:
        return torch.ones_like(torch.atleast_1d(steps))

    def q_step_from_x_0(self, x_0, steps, noise):
        t = _b(torch.atleast_1d(torch.as_tensor(steps, dtype=torch.float32, device=x_0.device)))
        return (1.0 - t) * x_0 + t * noise

    def q_step(self, x_s, step_t, step_s, noise):
        """Forward re-noising s -> t (s < t) that keeps the path's marginal
        N((1 - t) x_0, t^2 I): scale by a = (1 - t)/(1 - s), top up with
        noise of variance t^2 - (a s)^2."""
        t = _b(torch.atleast_1d(torch.as_tensor(step_t, dtype=torch.float32, device=x_s.device)))
        s = _b(torch.atleast_1d(torch.as_tensor(step_s, dtype=torch.float32, device=x_s.device)))
        a = (1.0 - t) / (1.0 - s)
        var = torch.square(t) - torch.square(a * s)
        return x_s * a + torch.sqrt(torch.clamp(var, min=0.0)) * noise

    def _repaint_reverse_jumps(self, known, mask, x, step_t, step_s, draw: Draw, jump_length: int):
        """t -> s through ``jump_length`` Euler sub-steps, the known pixels
        blended in at their path marginal; one draw (the known noise) per
        sub-step."""
        interp = torch.linspace(0.0, 1.0, jump_length + 1, dtype=torch.float32, device=x.device)
        r_steps = step_t + interp * (step_s - step_t)
        for k in range(jump_length):
            known_s = self.q_step_from_x_0(known, r_steps[k + 1], draw(tuple(known.shape)))
            unknown_s = self.ode_step(x, r_steps[k], r_steps[k + 1], mode="euler")
            x = mask * known_s + (1.0 - mask) * unknown_s
        return x

    # sampling ----------------------------------------------------------------
    def _velocity(self, x: torch.Tensor, t) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        cond = self.get_network_condition(torch.atleast_1d(t).expand(x.shape[0]))
        return self.model(x, cond).to(torch.float32)

    def ode_step(self, x: torch.Tensor, t, s, mode: str = "euler") -> torch.Tensor:
        """One ODE step from time ``t`` to ``s`` (s < t)."""
        x = x.to(torch.float32)
        dt = s - t  # negative: noise -> data
        if mode == "euler":
            return x + dt * self._velocity(x, t)
        if mode == "midpoint":
            v1 = self._velocity(x, t)
            x_mid = x + 0.5 * dt * v1
            v2 = self._velocity(x_mid, t + 0.5 * dt)
            return x + dt * v2
        raise ValueError(f"invalid flow sampling mode {mode}")

    @torch.inference_mode()
    def sample_segment(
        self,
        x: torch.Tensor,
        ts_seg: torch.Tensor,
        mode: str = "euler",
        ddim_eta: float = 0.0,
        generator: Generators = None,
        noise: Optional[torch.Tensor] = None,
        return_all: bool = False,
    ):
        """The ODE over boundary times ``ts_seg`` ((K+1,)); ``ddim_eta``,
        ``generator`` and ``noise`` are accepted for a uniform sampler
        interface and unused (the ODE draws nothing). Returns x, or (x, the
        (K, B, H, W, C) stack) with ``return_all``."""
        del ddim_eta, generator, noise
        xs = []
        for i in range(ts_seg.shape[0] - 1):
            with trace.span("sampler.step", device=x):
                x = self.ode_step(x, ts_seg[i], ts_seg[i + 1], mode=mode)
            if return_all:
                xs.append(x)
        return (x, stack_steps(xs, x)) if return_all else x

    @torch.inference_mode()
    def sample(
        self,
        batch_size: int,
        num_steps: int,
        mode: str = "euler",
        ddim_eta: float = 0.0,
        generator: Generators = None,
        x_T: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        device=None,
        return_all: bool = False,
        segment_steps: Optional[int] = None,
        on_segment: OnSegment = None,
    ) -> torch.Tensor:
        """The full reverse ODE; a generator draws the same x(1) as the
        Gaussian samplers draw x_T. ``segment_steps``/``on_segment`` as in
        :meth:`_run_chain`."""
        device = self._device(device)
        x = self._x_T(batch_size, generator, x_T, device)
        ts = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32, device=device)

        def run(x, lo, hi):
            return self.sample_segment(x, ts[lo:hi + 1], mode, return_all=return_all)

        return self._run_chain(x, num_steps, run, return_all, segment_steps, on_segment)
