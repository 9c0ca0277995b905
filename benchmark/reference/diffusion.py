"""Continuous-time Gaussian diffusion in plain float32: R2DM's sampler maths
and training loss (kazuto1011/r2dm ``models/diffusion/continuous_time.py``,
the VDM formulation), written from the equations.

- cosine log-SNR schedule: logSNR(t) = -2 log tan(t_min + t (t_max - t_min)),
  with logSNR in [-15, 15]; alpha^2 = sigmoid(logSNR), sigma^2 = sigmoid(-logSNR);
- the network predicts eps; x_0 = clip((x_t - sigma_t eps) / alpha_t, -1, 1);
- DDPM step t -> s: c = -expm1(logSNR_t - logSNR_s),
  x_s = alpha_s (x_t (1 - c) / alpha_t + c x_0) + sigma_s sqrt(c) z;
- DDIM step (eta = 0): x_s = alpha_s x_0 + sqrt(1 - alpha_s^2) (x_t - alpha_t x_0) / sigma_t;
- the boundary times of an N-step chain are linspace(1, 0, N + 1);
- loss: t ~ U[0, 1), eps ~ N(0, I), x_t = alpha x_0 + sigma eps, the
  per-sample mean squared error times min(SNR, 5) / SNR, averaged over the batch.
"""

from __future__ import annotations

import math

import torch

LOGSNR_MIN, LOGSNR_MAX = -15.0, 15.0
MIN_SNR_GAMMA = 5.0


def logsnr(t: torch.Tensor) -> torch.Tensor:
    t_min = math.atan(math.exp(-0.5 * LOGSNR_MAX))
    t_max = math.atan(math.exp(-0.5 * LOGSNR_MIN))
    return -2.0 * torch.log(torch.clamp(torch.tan(t_min + t.float() * (t_max - t_min)), min=1e-20))


def alpha_sigma(lsnr: torch.Tensor):
    return torch.sqrt(torch.sigmoid(lsnr)), torch.sqrt(torch.sigmoid(-lsnr))


def boundary_times(num_steps: int, device=None) -> torch.Tensor:
    return torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32, device=device)


def _b(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


def _coefficients(t: float, s: float, B: int, device, dtype):
    l_t = logsnr(torch.full((B,), float(t), device=device))
    l_s = logsnr(torch.full((B,), float(s), device=device))
    a_t, s_t = alpha_sigma(_b(l_t))
    a_s, s_s = alpha_sigma(_b(l_s))
    c = -torch.expm1(_b(l_t) - _b(l_s))
    return [v.to(dtype) for v in (a_t, s_t, a_s, s_s, c)]


def ddpm_step(x_t, eps, t: float, s: float, z, dtype=torch.float32) -> torch.Tensor:
    """One DDPM step of the (B, H, W, C) x_t given the network's eps and the
    step's standard-normal draw z, computed in ``dtype`` (float32 unless the
    check's control asks for less); float32 out."""
    a_t, s_t, a_s, s_s, c = _coefficients(t, s, x_t.shape[0], x_t.device, dtype)
    x_t, eps, z = x_t.to(dtype), eps.to(dtype), z.to(dtype)
    x_0 = torch.clamp((x_t - s_t * eps) / a_t, -1.0, 1.0)
    return (a_s * (x_t * (1.0 - c) / a_t + c * x_0) + s_s * torch.sqrt(c) * z).float()


def ddim_step(x_t, eps, t: float, s: float, dtype=torch.float32) -> torch.Tensor:
    a_t, s_t, a_s, _, _ = _coefficients(t, s, x_t.shape[0], x_t.device, dtype)
    x_t, eps = x_t.to(dtype), eps.to(dtype)
    x_0 = torch.clamp((x_t - s_t * eps) / a_t, -1.0, 1.0)
    return (a_s * x_0 + torch.sqrt(1.0 - a_s ** 2) * (x_t - a_t * x_0) / s_t).float()


def noised(x_0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor):
    """(x_t, logSNR(t)): the network's input and condition in training."""
    lsnr = logsnr(t)
    a, s = alpha_sigma(_b(lsnr))
    return a * x_0 + s * noise, lsnr


def per_sample_loss(net, x_0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """(B,) min-SNR-weighted mean squared eps errors of ``net`` on NHWC x_0."""
    x_t, lsnr = noised(x_0, t, noise)
    err = torch.square(net(x_t, lsnr).float() - noise).mean(dim=(1, 2, 3))
    snr = torch.exp(lsnr)
    return err * torch.clamp(snr, max=MIN_SNR_GAMMA) / snr
