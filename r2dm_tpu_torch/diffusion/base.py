"""Shared Gaussian-diffusion machinery: what sampling needs.

The port of ``r2dm_tpu/diffusion/base.py`` for the sampling slice: the
constructor fields, ``_clip`` and the noise source. Randomness comes from
explicit ``torch.Generator``s: one generator for the whole batch, or a list
with one generator per sample, so that row i depends on generator i alone
(the reference's list-of-generators API, base.py:71-94).

Layout: NHWC (B, H, W, C) throughout the diffusion core.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

Generators = Union[None, torch.Generator, Sequence[torch.Generator]]


def normal(generator: Generators, shape: tuple[int, ...], device) -> torch.Tensor:
    """Standard normal fp32 of ``shape``; with a list of generators, row i
    is drawn from generator i."""
    if generator is None or isinstance(generator, torch.Generator):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    if len(generator) != shape[0]:
        raise ValueError(f"{len(generator)} generators for a batch of {shape[0]}")
    return torch.stack([
        torch.randn(shape[1:], generator=g, device=device, dtype=torch.float32)
        for g in generator
    ])


class GaussianDiffusion:
    """Config/behaviour base: ``model`` is an ``nn.Module`` exposing
    ``in_channels`` and ``resolution`` and called as ``model(x_nhwc,
    condition) -> prediction_nhwc``."""

    def __init__(
        self,
        model,
        prediction_type: str = "eps",
        loss_type: str = "l2",
        num_training_steps: Optional[int] = 1000,
        noise_schedule: str = "linear",
        min_snr_loss_weight: bool = True,
        min_snr_gamma: float = 5.0,
        sampling_resolution: Optional[tuple[int, int]] = None,
        clip_sample: bool = True,
        clip_sample_range: float = 1.0,
    ):
        assert prediction_type in ("eps", "v", "x_0")
        self.model = model
        self.objective = prediction_type
        self.loss_type = loss_type
        self.num_training_steps = num_training_steps
        self.noise_schedule = noise_schedule
        self.min_snr_loss_weight = min_snr_loss_weight
        self.min_snr_gamma = min_snr_gamma
        self.clip_sample = clip_sample
        self.clip_sample_range = clip_sample_range
        resolution = sampling_resolution if sampling_resolution is not None else model.resolution
        self.in_channels = int(model.in_channels)
        self.resolution = tuple(resolution)
        self.sampling_shape = (*self.resolution, self.in_channels)

    def _clip(self, x_0: torch.Tensor) -> torch.Tensor:
        if self.clip_sample:
            return torch.clamp(x_0, -self.clip_sample_range, self.clip_sample_range)
        return x_0
