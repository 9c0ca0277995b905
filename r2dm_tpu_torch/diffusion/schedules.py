"""Noise schedules: continuous-time log-SNR schedules, fp32 torch functions
of t in [0, 1] (``r2dm_tpu/diffusion/schedules.py:26-112``, reference
``models/diffusion/continuous_time.py:14-63``), and the discrete-time beta
tables, numpy float64 then fp32 (``r2dm_tpu/diffusion/schedules.py:114-172``,
reference ``models/diffusion/discrete_time.py:12-78``)."""

from __future__ import annotations

import math

import numpy as np
import torch


def _log(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=eps))


def logsnr_linear(t: torch.Tensor) -> torch.Tensor:
    """-log(expm1(1e-4 + 10 t^2))."""
    return -_log(torch.expm1(1e-4 + 10.0 * torch.square(t)))


def logsnr_cosine(t: torch.Tensor, logsnr_min: float = -15.0, logsnr_max: float = 15.0) -> torch.Tensor:
    """-2 log tan(t_min + t (t_max - t_min))."""
    t_min = math.atan(math.exp(-0.5 * logsnr_max))
    t_max = math.atan(math.exp(-0.5 * logsnr_min))
    return -2.0 * _log(torch.tan(t_min + t * (t_max - t_min)))


def logsnr_cosine_shifted(
    t: torch.Tensor, image_d: float, noise_d: float,
    logsnr_min: float = -15.0, logsnr_max: float = 15.0,
) -> torch.Tensor:
    """Cosine schedule shifted by 2 log(noise_d / image_d)."""
    return logsnr_cosine(t, logsnr_min, logsnr_max) + 2.0 * math.log(noise_d / image_d)


def logsnr_cosine_interpolated(
    t: torch.Tensor, image_d: float, noise_d_low: float, noise_d_high: float,
    logsnr_min: float = -15.0, logsnr_max: float = 15.0,
) -> torch.Tensor:
    """Elementwise t-interpolation between the low/high shifted schedules
    (the JAX package's deliberate deviation from the reference's broadcast,
    r2dm_tpu/diffusion/schedules.py:68-76)."""
    low = logsnr_cosine_shifted(t, image_d, noise_d_low, logsnr_min, logsnr_max)
    high = logsnr_cosine_shifted(t, image_d, noise_d_high, logsnr_min, logsnr_max)
    return t * low + (1.0 - t) * high


def logsnr_to_alpha_sigma(log_snr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """alpha = sqrt(sigmoid(logSNR)), sigma = sqrt(sigmoid(-logSNR))."""
    return torch.sqrt(torch.sigmoid(log_snr)), torch.sqrt(torch.sigmoid(-log_snr))


def make_logsnr_fn(
    noise_schedule: str,
    image_d: float | None = None,
    noise_d_low: float | None = None,
    noise_d_high: float | None = None,
):
    """Schedule name -> t -> logSNR function."""
    if noise_schedule == "linear":
        return logsnr_linear
    if noise_schedule == "cosine":
        return logsnr_cosine
    if noise_schedule == "cosine_shifted":
        assert image_d is not None and noise_d_low is not None
        return lambda t: logsnr_cosine_shifted(t, image_d, noise_d_low)
    if noise_schedule == "cosine_interpolated":
        assert None not in (image_d, noise_d_low, noise_d_high)
        return lambda t: logsnr_cosine_interpolated(t, image_d, noise_d_low, noise_d_high)
    raise ValueError(f"invalid noise schedule: {noise_schedule}")


# ----------------------------------------------------------------- discrete
def linear_beta_schedule(steps: int) -> np.ndarray:
    """The DDPM linear schedule scaled to the step count, float64."""
    scale = 1000.0 / steps
    return np.linspace(scale * 0.0001, scale * 0.02, steps, dtype=np.float64)


def cosine_beta_schedule(steps: int, s: float = 0.008) -> np.ndarray:
    """Nichol-Dhariwal cosine schedule."""
    t = np.linspace(0.0, steps, steps + 1, dtype=np.float64) / steps
    alphas_bar = np.cos((t + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_bar = alphas_bar / alphas_bar[0]
    betas = 1.0 - alphas_bar[1:] / alphas_bar[:-1]
    return np.clip(betas, 0.0, 0.999)


def sigmoid_beta_schedule(steps: int, start: float = -3.0, end: float = 3.0, tau: float = 1.0) -> np.ndarray:
    """Sigmoid schedule (arXiv 2212.11972 Fig. 8)."""

    def sigmoid(x):
        return 1.0 / (1.0 + np.exp(-x))

    t = np.linspace(0.0, steps, steps + 1, dtype=np.float64) / steps
    v_start = sigmoid(start / tau)
    v_end = sigmoid(end / tau)
    alphas_bar = (-sigmoid((t * (end - start) + start) / tau) + v_end) / (v_end - v_start)
    alphas_bar = alphas_bar / alphas_bar[0]
    betas = 1.0 - alphas_bar[1:] / alphas_bar[:-1]
    return np.clip(betas, 0.0, 0.999)


def make_beta_table(noise_schedule: str, steps: int) -> np.ndarray:
    if noise_schedule == "linear":
        return linear_beta_schedule(steps)
    if noise_schedule == "cosine":
        return cosine_beta_schedule(steps)
    if noise_schedule == "sigmoid":
        return sigmoid_beta_schedule(steps)
    raise ValueError(f"invalid beta schedule: {noise_schedule}")


def discrete_tables(noise_schedule: str, steps: int) -> dict[str, np.ndarray]:
    """fp32 tables {beta, alpha_bar, alpha_bar_prev, snr}; the cumprod runs
    in float64 before the cast."""
    beta = make_beta_table(noise_schedule, steps)
    alpha_bar = np.cumprod(1.0 - beta)
    alpha_bar_prev = np.concatenate([[1.0], alpha_bar[:-1]])
    snr = alpha_bar / (1.0 - alpha_bar)
    return {
        "beta": beta.astype(np.float32),
        "alpha_bar": alpha_bar.astype(np.float32),
        "alpha_bar_prev": alpha_bar_prev.astype(np.float32),
        "snr": snr.astype(np.float32),
    }
