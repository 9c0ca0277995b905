"""Discrete-time DDPM (arXiv 2006.11239).

Port of ``r2dm_tpu/diffusion/discrete.py`` (reference
``models/diffusion/discrete_time.py:51-201``): precomputed beta tables
(linear/cosine/sigmoid, float64 cumprod then fp32), eps/v/x0 prediction,
DDPM and DDIM p-steps with the noise zeroed at step 0, and the chain over
the descending step indices T-1..0 as a Python loop. The network sees the
integer step index as its condition. The training hooks are here so that
the class is whole; training itself is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..utils import trace
from . import schedules
from .base import GaussianDiffusion, Generators, OnSegment, _b, stack_steps

Steps = Union[int, torch.Tensor]


class DiscreteTimeGaussianDiffusion(GaussianDiffusion):
    def __init__(
        self,
        model,
        prediction_type: str = "eps",
        loss_type: str = "l2",
        num_training_steps: int = 1000,
        noise_schedule: str = "linear",
        min_snr_loss_weight: bool = True,
        min_snr_gamma: float = 5.0,
        sampling_resolution: Optional[tuple[int, int]] = None,
        clip_sample: bool = True,
        clip_sample_range: float = 1.0,
    ):
        super().__init__(
            model=model,
            prediction_type=prediction_type,
            loss_type=loss_type,
            num_training_steps=num_training_steps,
            noise_schedule=noise_schedule,
            min_snr_loss_weight=min_snr_loss_weight,
            min_snr_gamma=min_snr_gamma,
            sampling_resolution=sampling_resolution,
            clip_sample=clip_sample,
            clip_sample_range=clip_sample_range,
        )
        tables = schedules.discrete_tables(noise_schedule, num_training_steps)
        self.tables = {k: torch.from_numpy(v) for k, v in tables.items()}
        self._device_tables: dict = {}

    def table(self, name: str, device) -> torch.Tensor:
        """One fp32 table (beta, alpha_bar, alpha_bar_prev, snr), kept on
        ``device`` after its first use."""
        key = (name, torch.device(device))
        if key not in self._device_tables:
            self._device_tables[key] = self.tables[name].to(device)
        return self._device_tables[key]

    def _at(self, name: str, steps: torch.Tensor) -> torch.Tensor:
        return _b(self.table(name, steps.device)[steps])

    @staticmethod
    def _steps(steps: Steps, B: int, device) -> torch.Tensor:
        """(B,) int64 step indices on ``device``: an int fills without a
        copy from the host."""
        if isinstance(steps, int):
            return torch.full((B,), steps, dtype=torch.int64, device=device)
        return torch.atleast_1d(torch.as_tensor(steps, device=device)).to(torch.int64).expand(B)

    # ------------------------------------------------------------- training
    def sample_timesteps(self, batch_size: int, generator: Generators = None, device=None) -> torch.Tensor:
        """Uniform step indices in [0, T) (reference discrete_time.py:80-88)."""
        return torch.randint(
            0, self.num_training_steps, (batch_size,), generator=generator, device=self._device(device)
        )

    def get_network_condition(self, steps: torch.Tensor) -> torch.Tensor:
        return torch.atleast_1d(steps)

    def get_target(self, x_0, steps, noise):
        if self.objective == "eps":
            return noise
        if self.objective == "x_0":
            return x_0
        if self.objective == "v":
            alpha_bar = self._at("alpha_bar", torch.atleast_1d(steps))
            return torch.sqrt(alpha_bar) * noise - torch.sqrt(1.0 - alpha_bar) * x_0
        raise ValueError(f"invalid objective {self.objective}")

    def get_loss_weight(self, steps) -> torch.Tensor:
        steps = torch.atleast_1d(steps)
        snr = self.table("snr", steps.device)[steps]
        clipped = torch.clamp(snr, max=self.min_snr_gamma) if self.min_snr_loss_weight else snr
        if self.objective == "eps":
            return clipped / snr
        if self.objective == "x_0":
            return clipped
        if self.objective == "v":
            return clipped / (snr + 1.0)
        raise ValueError(f"invalid objective {self.objective}")

    # ------------------------------------------------------------ processes
    def q_step_from_x_0(self, x_0, steps, noise):
        alpha_bar = self._at("alpha_bar", self._steps(steps, x_0.shape[0], x_0.device))
        return torch.sqrt(alpha_bar) * x_0 + torch.sqrt(1.0 - alpha_bar) * noise

    def p_step(
        self,
        x_t: torch.Tensor,
        steps: Steps,
        noise: Optional[torch.Tensor] = None,
        mode: str = "ddpm",
        eta: float = 0.0,
    ) -> torch.Tensor:
        """One reverse step (reference discrete_time.py:126-180); the noise is
        zeroed where ``steps == 0`` (discrete_time.py:162,176-177)."""
        B = x_t.shape[0]
        x_t = x_t.to(torch.float32)
        steps = self._steps(steps, B, x_t.device)
        beta = self._at("beta", steps)
        alpha = 1.0 - beta
        alpha_bar = self._at("alpha_bar", steps)
        alpha_bar_prev = self._at("alpha_bar_prev", steps)
        prediction = self.model(x_t, steps).to(torch.float32)
        if self.objective == "eps":
            x_0 = torch.rsqrt(alpha_bar) * x_t - torch.sqrt(1.0 / alpha_bar - 1.0) * prediction
        elif self.objective == "x_0":
            x_0 = prediction
        elif self.objective == "v":
            x_0 = torch.sqrt(alpha_bar) * x_t - torch.sqrt(1.0 - alpha_bar) * prediction
        else:
            raise ValueError(f"invalid objective {self.objective}")
        x_0 = self._clip(x_0)
        if noise is None:
            noise = torch.zeros_like(x_t)
        noise = noise * _b((steps > 0).to(torch.float32))
        if mode == "ddpm":
            x_0_coef = torch.sqrt(alpha_bar_prev) * beta / (1.0 - alpha_bar)
            x_t_coef = (1.0 - alpha_bar_prev) * torch.sqrt(alpha) / (1.0 - alpha_bar)
            mean = x_0_coef * x_0 + x_t_coef * x_t
            var = beta * (1.0 - alpha_bar_prev) / (1.0 - alpha_bar)
            var = torch.clamp(var, min=1e-20)
            std = torch.exp(0.5 * torch.log(var))
            return mean + std * noise
        if mode == "ddim":
            var = (1.0 - alpha_bar_prev) / (1.0 - alpha_bar) * (1.0 - alpha_bar / alpha_bar_prev)
            std_dev = eta * torch.sqrt(var)
            eps = (x_t - torch.sqrt(alpha_bar) * x_0) / torch.sqrt(1.0 - alpha_bar)
            x_s = torch.sqrt(alpha_bar_prev) * x_0 + torch.sqrt(1.0 - alpha_bar_prev - torch.square(std_dev)) * eps
            if eta > 0:
                x_s = x_s + std_dev * noise
            return x_s
        raise ValueError(f"invalid mode {mode}")

    # ------------------------------------------------------------- sampling
    @torch.inference_mode()
    def sample_segment(
        self,
        x: torch.Tensor,
        timesteps_seg,
        mode: str = "ddpm",
        eta: float = 0.0,
        generator: Generators = None,
        noise: Optional[torch.Tensor] = None,
        return_all: bool = False,
    ):
        """``p_step`` over a slice of the descending step indices; ``noise``
        ((K, B, H, W, C)) replaces the generator's draws. Returns x, or (x,
        the (K, B, H, W, C) stack) with ``return_all``; chaining segments
        over ``T-1, ..., 0`` is :meth:`sample`."""
        stochastic = mode == "ddpm" or eta > 0
        xs = []
        for i, t in enumerate(torch.as_tensor(timesteps_seg).tolist()):
            with trace.span("sampler.step", device=x):
                if noise is not None:
                    n = noise[i]
                elif stochastic:
                    n = self._normal(generator, x.shape, x.device)
                else:
                    n = None
                x = self.p_step(x, int(t), noise=n, mode=mode, eta=eta)
            if return_all:
                xs.append(x)
        return (x, stack_steps(xs, x)) if return_all else x

    @torch.inference_mode()
    def sample(
        self,
        batch_size: int,
        num_steps: Optional[int] = None,
        mode: str = "ddpm",
        eta: float = 0.0,
        generator: Generators = None,
        x_T: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        device=None,
        return_all: bool = False,
        segment_steps: Optional[int] = None,
        on_segment: OnSegment = None,
    ) -> torch.Tensor:
        """The reverse chain over steps ``num_steps - 1, ..., 0`` (reference
        discrete_time.py:182-201); ``segment_steps``/``on_segment`` as in
        :meth:`_run_chain`."""
        num_steps = self.num_training_steps if num_steps is None else num_steps
        device = self._device(device)
        x = self._x_T(batch_size, generator, x_T, device)
        noise = self._shard(noise, dim=3)
        ts = self.timesteps(num_steps)

        def run(x, lo, hi):
            seg_noise = None if noise is None else noise[lo:hi]
            return self.sample_segment(x, ts[lo:hi], mode, eta, generator, seg_noise, return_all)

        return self._run_chain(x, num_steps, run, return_all, segment_steps, on_segment)

    @staticmethod
    def timesteps(num_steps: int) -> torch.Tensor:
        """The descending step indices T-1, ..., 0 (on the host)."""
        return torch.arange(num_steps - 1, -1, -1, dtype=torch.int64)
