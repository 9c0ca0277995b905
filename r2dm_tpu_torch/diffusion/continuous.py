"""Continuous-time Gaussian diffusion (VDM, arXiv 2107.00630): the sampler.

Port of the sampling half of ``r2dm_tpu/diffusion/continuous.py``
(reference ``models/diffusion/continuous_time.py:66-258``): log-SNR
schedules, eps/v/x0 prediction, DDPM and DDIM reverse steps. ``sample`` and
``sample_segment`` are Python loops over boundary times
``linspace(1, 0, N+1)`` in fp32; the network sees the log-SNR as its
condition. Schedule and step maths stay fp32 whatever the network's compute
dtype. Noise comes from explicit generators, or is passed in (``x_T=``,
``noise=``) so that tests can feed both frameworks the same numbers.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import schedules
from .base import GaussianDiffusion, Generators, normal


def _b(x: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, 1) against NHWC images."""
    return x.reshape(-1, 1, 1, 1)


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

    def _steps(self, step, B: int, device) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32, device=device)
        return self.log_snr(torch.atleast_1d(step).expand(B))

    def q_step_from_x_0(self, x_0, step_t, noise):
        """x_t = alpha x_0 + sigma eps (reference continuous_time.py:169-176)."""
        alpha, sigma = schedules.logsnr_to_alpha_sigma(_b(self._steps(step_t, x_0.shape[0], x_0.device)))
        return x_0 * alpha + noise * sigma

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
    ) -> torch.Tensor:
        """``p_step`` over the boundary times ``ts_seg`` ((K+1,)); ``noise``
        ((K, B, H, W, C)) replaces the generator's draws."""
        stochastic = mode == "ddpm" or ddim_eta != 0.0
        for i in range(ts_seg.shape[0] - 1):
            if noise is not None:
                n = noise[i]
            elif stochastic:
                n = normal(generator, tuple(x.shape), x.device)
            else:
                n = None
            x = self.p_step(x, ts_seg[i], ts_seg[i + 1], noise=n, mode=mode, ddim_eta=ddim_eta)
        return x

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
    ) -> torch.Tensor:
        """The full reverse chain (reference continuous_time.py:234-258):
        (B, H, W, C) fp32 in [-1, 1]."""
        if device is None:
            device = next(self.model.parameters()).device
        if x_T is None:
            x = normal(generator, (batch_size, *self.sampling_shape), device)
        else:
            x = x_T.to(device=device, dtype=torch.float32)
        ts = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32, device=device)
        return self.sample_segment(x, ts, mode, ddim_eta, generator, noise)
