"""Continuous-time Gaussian diffusion (VDM, arXiv 2107.00630).

Port of ``r2dm_tpu/diffusion/continuous.py``
(reference ``models/diffusion/continuous_time.py:66-317``): log-SNR
schedules, eps/v/x0 prediction, the training hooks (t ~ U[0, 1), the
target, the min-SNR loss weight), DDPM and DDIM reverse steps, DPM-Solver++
(2M), and the RePaint hooks (``q_step``, ``_repaint_reverse_jumps``; the
loops are in ``base.py``). ``sample``, ``sample_segment`` and
``dpmpp_2m_segment`` are Python loops over boundary times
``linspace(1, 0, N+1)`` in fp32; the network sees the log-SNR as its
condition. Schedule and step maths stay fp32 whatever the network's compute
dtype. Noise comes from explicit generators, or is passed in (``x_T=``,
``noise=``) so that tests can feed both frameworks the same numbers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils import trace
from . import schedules
from .base import Draw, GaussianDiffusion, Generators, OnSegment, _b, stack_steps


class ContinuousTimeGaussianDiffusion(GaussianDiffusion):
    def __init__(
        self,
        model,
        prediction_type: str = "eps",
        loss_type: str = "l2",
        noise_schedule: str = "cosine",
        min_snr_loss_weight: bool = True,
        min_snr_gamma: float = 5.0,
        sampling_resolution: Optional[tuple[int, int]] = None,
        clip_sample: bool = True,
        clip_sample_range: float = 1.0,
        image_d: Optional[float] = None,
        noise_d_low: Optional[float] = None,
        noise_d_high: Optional[float] = None,
    ):
        super().__init__(
            model=model,
            prediction_type=prediction_type,
            loss_type=loss_type,
            num_training_steps=None,
            noise_schedule=noise_schedule,
            min_snr_loss_weight=min_snr_loss_weight,
            min_snr_gamma=min_snr_gamma,
            sampling_resolution=sampling_resolution,
            clip_sample=clip_sample,
            clip_sample_range=clip_sample_range,
        )
        self.log_snr = schedules.make_logsnr_fn(noise_schedule, image_d, noise_d_low, noise_d_high)

    # ------------------------------------------------------------- training
    def sample_timesteps(self, batch_size: int, generator: Generators = None, device=None) -> torch.Tensor:
        """t ~ U[0, 1) (reference continuous_time.py:133-135)."""
        return torch.rand((batch_size,), generator=generator, device=self._device(device))

    def get_network_condition(self, steps: torch.Tensor) -> torch.Tensor:
        return self.log_snr(torch.atleast_1d(steps).to(torch.float32))

    def get_target(self, x_0, step_t, noise):
        if self.objective == "eps":
            return noise
        if self.objective == "x_0":
            return x_0
        if self.objective == "v":
            alpha, sigma = schedules.logsnr_to_alpha_sigma(_b(self.get_network_condition(step_t)))
            return alpha * noise - sigma * x_0
        raise ValueError(f"invalid objective {self.objective}")

    def get_loss_weight(self, steps) -> torch.Tensor:
        """min-SNR-gamma weighting (reference continuous_time.py:153-167)."""
        snr = torch.exp(self.get_network_condition(steps))
        clipped = torch.clamp(snr, max=self.min_snr_gamma) if self.min_snr_loss_weight else snr
        if self.objective == "eps":
            return clipped / snr
        if self.objective == "x_0":
            return clipped
        if self.objective == "v":
            return clipped / (snr + 1.0)
        raise ValueError(f"invalid objective {self.objective}")

    # ------------------------------------------------------------ processes
    def _steps(self, step, B: int, device) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32, device=device)
        return self.log_snr(torch.atleast_1d(step).expand(B))

    def q_step_from_x_0(self, x_0, step_t, noise):
        """x_t = alpha x_0 + sigma eps (reference continuous_time.py:169-176)."""
        alpha, sigma = schedules.logsnr_to_alpha_sigma(_b(self._steps(step_t, x_0.shape[0], x_0.device)))
        return x_0 * alpha + noise * sigma

    def q_step(self, x_s, step_t, step_s, noise):
        """q(z_t | z_s), 0 < s < t < 1 (reference continuous_time.py:178-190)."""
        B = x_s.shape[0]
        alpha_t, sigma_t = schedules.logsnr_to_alpha_sigma(_b(self._steps(step_t, B, x_s.device)))
        alpha_s, sigma_s = schedules.logsnr_to_alpha_sigma(_b(self._steps(step_s, B, x_s.device)))
        alpha_ts = alpha_t / alpha_s
        var = torch.square(sigma_t) - torch.square(alpha_ts) * torch.square(sigma_s)
        return x_s * alpha_ts + torch.sqrt(var) * noise

    def _model_x0(self, x_t: torch.Tensor, log_snr_t: torch.Tensor) -> torch.Tensor:
        """Network at (x_t, logSNR_t) -> clipped x_0 estimate
        (reference continuous_time.py:205-219)."""
        alpha_t, sigma_t = schedules.logsnr_to_alpha_sigma(_b(log_snr_t))
        prediction = self.model(x_t, log_snr_t).to(torch.float32)
        if self.objective == "eps":
            x_0 = (x_t - sigma_t * prediction) / alpha_t
        elif self.objective == "v":
            x_0 = alpha_t * x_t - sigma_t * prediction
        elif self.objective == "x_0":
            x_0 = prediction
        else:
            raise ValueError(f"invalid objective {self.objective}")
        return self._clip(x_0)

    def p_step(
        self,
        x_t: torch.Tensor,
        step_t,
        step_s,
        noise: Optional[torch.Tensor] = None,
        mode: str = "ddpm",
        ddim_eta: float = 0.0,
    ) -> torch.Tensor:
        """One reverse step p(z_s | z_t) (reference continuous_time.py:192-232);
        ``noise=None`` takes the deterministic mean."""
        B = x_t.shape[0]
        x_t = x_t.to(torch.float32)
        log_snr_t = self._steps(step_t, B, x_t.device)
        log_snr_s = self._steps(step_s, B, x_t.device)
        alpha_t, sigma_t = schedules.logsnr_to_alpha_sigma(_b(log_snr_t))
        alpha_s, sigma_s = schedules.logsnr_to_alpha_sigma(_b(log_snr_s))
        x_0 = self._model_x0(x_t, log_snr_t)
        if noise is None:
            noise = torch.zeros_like(x_t)
        if mode == "ddpm":
            c = -torch.expm1(_b(log_snr_t) - _b(log_snr_s))
            mean = alpha_s * (x_t * (1.0 - c) / alpha_t + c * x_0)
            std = sigma_s * torch.sqrt(c)
            return mean + std * noise
        if mode == "ddim":
            c_1 = ddim_eta * sigma_s / sigma_t * torch.sqrt(1.0 - torch.square(alpha_t) / torch.square(alpha_s))
            c_2 = torch.sqrt(1.0 - torch.square(alpha_s) - torch.square(c_1))
            eps = (x_t - alpha_t * x_0) / sigma_t
            return alpha_s * x_0 + c_1 * noise + c_2 * eps
        raise ValueError(f"invalid mode {mode}")

    @torch.inference_mode()
    def sample_segment(
        self,
        x: torch.Tensor,
        ts_seg: torch.Tensor,
        mode: str = "ddpm",
        ddim_eta: float = 0.0,
        generator: Generators = None,
        noise: Optional[torch.Tensor] = None,
        return_all: bool = False,
    ):
        """``p_step`` over the boundary times ``ts_seg`` ((K+1,)); ``noise``
        ((K, B, H, W, C)) replaces the generator's draws. Returns x, or
        (x, the (K, B, H, W, C) stack of every step) with ``return_all``."""
        stochastic = mode == "ddpm" or ddim_eta != 0.0
        xs = []
        for i in range(ts_seg.shape[0] - 1):
            with trace.span("sampler.step", device=x):
                if noise is not None:
                    n = noise[i]
                elif stochastic:
                    n = self._normal(generator, x.shape, x.device)
                else:
                    n = None
                x = self.p_step(x, ts_seg[i], ts_seg[i + 1], noise=n, mode=mode, ddim_eta=ddim_eta)
            if return_all:
                xs.append(x)
        return (x, stack_steps(xs, x)) if return_all else x

    @torch.inference_mode()
    def sample(
        self,
        batch_size: int,
        num_steps: int,
        mode: str = "ddpm",
        ddim_eta: float = 0.0,
        generator: Generators = None,
        x_T: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        device=None,
        return_all: bool = False,
        segment_steps: Optional[int] = None,
        on_segment: OnSegment = None,
    ) -> torch.Tensor:
        """The full reverse chain (reference continuous_time.py:234-258):
        (B, H, W, C) fp32 in [-1, 1], or (num_steps+1, B, H, W, C) with
        ``return_all``; ``segment_steps``/``on_segment`` as in
        :meth:`_run_chain`."""
        device = self._device(device)
        x = self._x_T(batch_size, generator, x_T, device)
        noise = self._shard(noise, dim=3)
        ts = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32, device=device)

        def run(x, lo, hi):
            seg_noise = None if noise is None else noise[lo:hi]
            return self.sample_segment(x, ts[lo:hi + 1], mode, ddim_eta, generator, seg_noise, return_all)

        return self._run_chain(x, num_steps, run, return_all, segment_steps, on_segment)

    # ------------------------------------------------- DPM-Solver++ (2M)
    # Second-order multistep ODE solver in the data-prediction
    # parameterisation (Lu et al., arXiv 2211.01095), an extension beyond the
    # reference's ddpm/ddim. Deterministic: only x_T is drawn.
    @torch.inference_mode()
    def dpmpp_2m_segment(
        self,
        x: torch.Tensor,
        prev_x0: torch.Tensor,
        prev_lam: torch.Tensor,
        ts_seg: torch.Tensor,
        second_order: Sequence[bool],
        return_all: bool = False,
    ) -> tuple:
        """The 2M update over ``ts_seg`` ((K+1,) boundary times). The carry
        is ``(x, prev_x0, prev_lam)``: the previous step's x_0 prediction and
        half-logSNR. ``second_order[i]`` False takes the first-order update
        (the global first step, with no history, and the global last step).
        Returns the carry, plus the (K, B, H, W, C) stack with
        ``return_all``; chaining segments is :meth:`sample_dpmpp`."""
        B = x.shape[0]
        xs = []
        for i in range(ts_seg.shape[0] - 1):
            with trace.span("sampler.step", device=x):
                x = x.to(torch.float32)
                log_snr_t = self._steps(ts_seg[i], B, x.device)
                log_snr_s = self._steps(ts_seg[i + 1], B, x.device)
                x0 = self._model_x0(x, log_snr_t)
                lam_t = 0.5 * _b(log_snr_t)  # lambda := log(alpha / sigma)
                lam_s = 0.5 * _b(log_snr_s)
                h = lam_s - lam_t
                d = x0 + h / (2.0 * (lam_t - prev_lam)) * (x0 - prev_x0) if second_order[i] else x0
                _, sigma_t = schedules.logsnr_to_alpha_sigma(_b(log_snr_t))
                alpha_s, sigma_s = schedules.logsnr_to_alpha_sigma(_b(log_snr_s))
                x = (sigma_s / sigma_t) * x - alpha_s * torch.expm1(-h) * d
            prev_x0, prev_lam = x0, lam_t
            if return_all:
                xs.append(x)
        carry = (x, prev_x0, prev_lam)
        return (*carry, stack_steps(xs, x)) if return_all else carry

    @staticmethod
    def dpmpp_second_order(num_steps: int) -> list[bool]:
        """First-order at the first and the last step, second-order between."""
        return [0 < i < num_steps - 1 for i in range(num_steps)]

    @torch.inference_mode()
    def sample_dpmpp(
        self,
        batch_size: int,
        num_steps: int,
        generator: Generators = None,
        x_T: Optional[torch.Tensor] = None,
        device=None,
        return_all: bool = False,
        segment_steps: Optional[int] = None,
        on_segment: OnSegment = None,
    ) -> torch.Tensor:
        """The full DPM-Solver++(2M) chain; a generator draws the same x_T
        as under :meth:`sample`."""
        device = self._device(device)
        x = self._x_T(batch_size, generator, x_T, device)
        ts = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32, device=device)
        second_order = self.dpmpp_second_order(num_steps)
        history = [torch.zeros_like(x), torch.zeros((batch_size, 1, 1, 1), dtype=torch.float32, device=device)]

        def run(x, lo, hi):
            out = self.dpmpp_2m_segment(x, *history, ts[lo:hi + 1], second_order[lo:hi], return_all)
            history[:] = out[1:3]
            return (out[0], out[3]) if return_all else out[0]

        return self._run_chain(x, num_steps, run, return_all, segment_steps, on_segment)

    def _repaint_reverse_jumps(self, known, mask, x, step_t, step_s, draw: Draw, jump_length: int):
        """t -> s through ``jump_length`` ddpm sub-steps, blending the known
        pixels (reference continuous_time.py:283-303); draws the known noise,
        then the p-step noise, per sub-step."""
        interp = torch.linspace(0.0, 1.0, jump_length + 1, dtype=torch.float32, device=x.device)
        r_steps = step_t + interp * (step_s - step_t)
        for k in range(jump_length):
            known_s = self.q_step_from_x_0(known, r_steps[k + 1], draw(tuple(known.shape)))
            unknown_s = self.p_step(x, r_steps[k], r_steps[k + 1], noise=draw(tuple(x.shape)))
            x = mask * known_s + (1.0 - mask) * unknown_s
        return x

