"""Continuous-time log-SNR noise schedules, fp32 torch functions of t in [0, 1]
(``r2dm_tpu/diffusion/schedules.py:26-112``, reference
``models/diffusion/continuous_time.py:14-63``)."""

from __future__ import annotations

import math

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
