"""Shared Gaussian-diffusion machinery: the constructor fields, ``_clip``, the
noise sources, the training loss, the chain driver of every sampler and the
RePaint loops.

The port of ``r2dm_tpu/diffusion/base.py``. Randomness comes from explicit
``torch.Generator``s: one generator for the whole batch, or a list with one
generator per sample, so that row i depends on generator i alone (the
reference's list-of-generators API, base.py:71-94). A caller may instead
pass a noise source (``noise=``): a callable ``shape -> tensor`` or an
iterator of tensors, drawn from in the order the JAX package splits its
keys, so that tests can feed both frameworks the same numbers.

The RePaint loops (``repaint``, ``repaint_segment``, ``repaint_final``,
``_repaint_forward_jumps``; reference continuous_time.py:260-317) are
generic over two hooks each process supplies: ``q_step`` and
``_repaint_reverse_jumps``. They are Python loops under
``torch.inference_mode()``.

The loss (``elementwise_loss``, ``masked_weighted_loss``, ``p_loss``,
``loss``; r2dm_tpu/diffusion/base.py:70-101, 315-357) is differentiable in
the network's parameters; the min-SNR weight applies per sample, the JAX
package's deliberate deviation from the reference.

Layout: NHWC (B, H, W, C) throughout the diffusion core.

Under a width axis (the network's ``width_shard``, ``models/layers.py::
set_width_shard``) the chains run on this rank's columns of each image. Every
draw is the whole image's, from the same generators as on one rank, and the
rank keeps its columns (``normal``/``noise_drawer`` with ``width``), so a
sharded chain is one rank's chain draw for draw. The full-width inputs
(``x_T``, ``noise``, RePaint's ``known`` and ``mask``) are cut to the rank's
columns the same way; the results are the rank's columns. The loss under a
width axis is the rank's columns' share of one rank's loss
(``masked_weighted_loss``): the shares sum to it over the width group.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Union

import torch

from ..parallel.width import all_reduce_sum_, shard_columns, sharded
from ..utils import trace

Generators = Union[None, torch.Generator, Sequence[torch.Generator]]
NoiseSource = Union[None, Callable[[tuple], torch.Tensor], Iterable[torch.Tensor]]
Draw = Callable[[tuple], torch.Tensor]
OnSegment = Optional[Callable[[int], None]]


def _full_width(shape: tuple, width) -> tuple:
    """The whole image's NHWC shape of a rank's ``shape``."""
    return (*shape[:2], shape[2] * width.width_size, *shape[3:])


def normal(generator: Generators, shape: tuple[int, ...], device, width=None) -> torch.Tensor:
    """Standard normal fp32 of ``shape``; with a list of generators, row i
    is drawn from generator i. Under a width axis (``width``) ``shape`` is
    the rank's and the draw the whole image's, of which the rank keeps its
    columns."""
    if sharded(width):
        return shard_columns(normal(generator, _full_width(tuple(shape), width), device), width)
    if generator is None or isinstance(generator, torch.Generator):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    if len(generator) != shape[0]:
        raise ValueError(f"{len(generator)} generators for a batch of {shape[0]}")
    return torch.stack([
        torch.randn(shape[1:], generator=g, device=device, dtype=torch.float32)
        for g in generator
    ])


def noise_drawer(generator: Generators, noise: NoiseSource, device, width=None) -> Draw:
    """``shape -> fp32 standard normal on device``: from ``noise`` (a
    callable taking the shape, or an iterator) when it is given, else from
    the generators. Under a width axis the draw is the whole image's and the
    rank keeps its columns, as in ``normal``."""
    if noise is None:
        return lambda shape: normal(generator, shape, device, width)
    source = noise if callable(noise) else (lambda shape, it=iter(noise): next(it))

    def draw(shape: tuple) -> torch.Tensor:
        full = _full_width(tuple(shape), width) if sharded(width) else tuple(shape)
        n = source(full)
        if tuple(n.shape) != full:
            raise ValueError(f"noise source gave shape {tuple(n.shape)}, the draw needs {full}")
        return shard_columns(n.to(device=device, dtype=torch.float32), width)

    return draw


def check_repaint_grid(num_steps: int, num_resample_steps: int, jump_length: int) -> None:
    if num_steps < 1 or num_resample_steps < 1 or jump_length < 1:
        raise ValueError(
            f"RePaint needs num_steps, num_resample_steps and jump_length >= 1, got "
            f"{num_steps}, {num_resample_steps}, {jump_length}"
        )


def stack_steps(xs: list, like: torch.Tensor) -> torch.Tensor:
    """The per-step stack (K, B, H, W, C) of a segment; empty for K = 0."""
    return torch.stack(xs) if xs else like.new_empty((0, *like.shape))


def elementwise_loss(kind: str, prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """l2 / l1 / huber (beta = 1), no reduction (reference base.py:39-48)."""
    diff = prediction - target
    if kind == "l2":
        return torch.square(diff)
    if kind == "l1":
        return torch.abs(diff)
    if kind == "huber":  # torch SmoothL1Loss, beta = 1.0
        a = torch.abs(diff)
        return torch.where(a < 1.0, 0.5 * torch.square(diff), a - 0.5)
    raise ValueError(f"invalid criterion: {kind}")


def masked_weighted_loss(loss: torch.Tensor, loss_mask: Optional[torch.Tensor], weight: torch.Tensor,
                         width=None) -> torch.Tensor:
    """Per-sample masked mean, times that sample's weight, then the batch
    mean. The reference broadcasts its (B, 1) loss against the (B, 1, 1, 1)
    weight and so averages mean(loss) * mean(weight); the JAX package
    applies the weight per sample, as min-SNR (arXiv 2303.09556) intends,
    and so does the port (r2dm_tpu/diffusion/base.py:83-101). Under a width
    axis (``width``) each sample's numerator is this rank's columns' and
    stays differentiable, its denominator (the mask's count) is the whole
    image's, summed over the width group without grad: the rank's share."""
    if loss_mask is None:
        loss_mask = torch.ones_like(loss)
    axes = tuple(range(1, loss.dim()))
    num = torch.sum(loss * loss_mask, dim=axes)
    den = torch.sum(loss_mask, dim=axes)
    if sharded(width):
        den = all_reduce_sum_(den.detach().to(torch.float32, copy=True), width).to(den.dtype)
    den = den + 1e-8
    per_sample = num / den  # (B,)
    return torch.mean(per_sample * weight.reshape(per_sample.shape))


def _b(x: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, 1) against NHWC images."""
    return x.reshape(-1, 1, 1, 1)


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

    def _device(self, device=None) -> torch.device:
        return torch.device(device) if device is not None else next(self.model.parameters()).device

    def _width(self):
        """The ``World`` whose width group splits the network's columns, or
        None."""
        return getattr(self.model, "width_shard", None)

    def _shard(self, x: Optional[torch.Tensor], dim: int = 2) -> Optional[torch.Tensor]:
        """A full-width input cut to this rank's columns along ``dim``."""
        return None if x is None else shard_columns(x, self._width(), dim)

    def _rank_shape(self, batch_size: int) -> tuple:
        """(B, H, W, C) of this rank's columns of a batch."""
        H, W, C = self.sampling_shape
        width = self._width()
        return (batch_size, H, W // width.width_size if sharded(width) else W, C)

    def _normal(self, generator: Generators, shape: tuple, device) -> torch.Tensor:
        """``normal`` for a tensor of the rank's ``shape``."""
        return normal(generator, tuple(shape), device, self._width())

    def _clip(self, x_0: torch.Tensor) -> torch.Tensor:
        if self.clip_sample:
            return torch.clamp(x_0, -self.clip_sample_range, self.clip_sample_range)
        return x_0

    # training ----------------------------------------------------------------
    def p_loss(
        self, model, x_0: torch.Tensor, steps: torch.Tensor, noise: torch.Tensor,
        loss_mask: Optional[torch.Tensor] = None, model_kwargs: Optional[dict] = None,
    ) -> torch.Tensor:
        """The masked, min-SNR-weighted denoising loss of ``model`` (called as
        ``model(x_t, condition, **model_kwargs)``) at the given steps and
        noise (reference base.py:122-139); differentiable in its parameters."""
        x_0 = x_0.to(torch.float32)
        x_t = self.q_step_from_x_0(x_0, steps, noise)
        prediction = model(x_t, self.get_network_condition(steps), **(model_kwargs or {})).to(torch.float32)
        loss = elementwise_loss(self.loss_type, prediction, self.get_target(x_0, steps, noise))
        return masked_weighted_loss(loss, loss_mask, self.get_loss_weight(steps), self._width())

    def loss(
        self, model, x_0: torch.Tensor, generator: Generators = None,
        loss_mask: Optional[torch.Tensor] = None, model_kwargs: Optional[dict] = None,
    ) -> torch.Tensor:
        """Timesteps, then noise, drawn from ``generator``, then
        :meth:`p_loss` (reference base.py:141-149); under a width axis the
        noise is the whole image's, cut to the rank's columns."""
        steps = self.sample_timesteps(x_0.shape[0], generator, x_0.device)
        noise = self._normal(generator, tuple(x_0.shape), x_0.device)
        return self.p_loss(model, x_0, steps, noise, loss_mask, model_kwargs)

    # the chain driver of every sampler ---------------------------------------
    def _x_T(self, batch_size, generator: Generators, x_T, device) -> torch.Tensor:
        """The chain's start: drawn from the generators, or ``x_T`` as fp32;
        under a width axis the rank's columns of either."""
        if x_T is None:
            x_T = normal(generator, (batch_size, *self.sampling_shape), device)
        return self._shard(x_T.to(device=device, dtype=torch.float32))

    @staticmethod
    def _run_chain(x, num_steps: int, run, return_all: bool, segment_steps: Optional[int], on_segment: OnSegment):
        """Drive ``run(x, lo, hi)`` (steps lo..hi-1 of a chain: x, or (x, the
        (hi-lo, B, H, W, C) stack) with ``return_all``) over segments of
        ``segment_steps`` steps, the whole chain by default, calling
        ``on_segment(hi)`` after each. Returns x, or with ``return_all`` the
        (num_steps+1, B, H, W, C) stack from x_T. Segments run the same
        operations as one pass."""
        stacks = [x[None]] if return_all else None
        seg = segment_steps or max(num_steps, 1)
        for lo in range(0, num_steps, seg):
            hi = min(lo + seg, num_steps)
            out = run(x, lo, hi)
            if return_all:
                x, stack = out
                stacks.append(stack)
            else:
                x = out
            if on_segment is not None:
                on_segment(hi)
        return torch.cat(stacks) if return_all else x

    # hooks of the RePaint loops ------------------------------------------
    def q_step(self, x_s, step_t, step_s, noise):
        """q(z_t | z_s), s < t (more noise at t): the re-noising hook."""
        raise NotImplementedError

    def _repaint_reverse_jumps(self, known, mask, x, step_t, step_s, draw: Draw, jump_length: int):
        """One reverse pass t -> s with the known pixels blended in."""
        raise NotImplementedError

    # RePaint loops (arXiv 2201.09865) ------------------------------------
    def _repaint_forward_jumps(self, x, step_t, step_s, draw: Draw, jump_length: int):
        """s -> t re-noising (reference continuous_time.py:309-315)."""
        interp = torch.linspace(0.0, 1.0, jump_length + 1, dtype=torch.float32, device=x.device)
        r_steps = step_t + interp * (step_s - step_t)
        for k in range(jump_length, 0, -1):
            x = self.q_step(x, r_steps[k - 1], r_steps[k], draw(tuple(x.shape)))
        return x

    def repaint_segment(
        self, known, mask, x_t, ts_pairs, draw: Draw,
        num_resample_steps: int = 1, jump_length: int = 1,
    ) -> torch.Tensor:
        """The RePaint outer loop over ``ts_pairs`` ((K, 2) rows of (t, s));
        chaining segments over ``stack([ts[:-2], ts[1:-1]], 1)`` and then
        :meth:`repaint_final` is :meth:`repaint`."""
        known = known.to(torch.float32)
        mask = mask.to(torch.float32)
        for step_t, step_s in ts_pairs:
            with trace.span("sampler.step", device=x_t):
                for j in range(num_resample_steps):
                    x_s = self._repaint_reverse_jumps(known, mask, x_t, step_t, step_s, draw, jump_length)
                    # re-noise unless this is the last resample of the step
                    if j == num_resample_steps - 1:
                        x_t = x_s
                    else:
                        x_t = self._repaint_forward_jumps(x_s, step_t, step_s, draw, jump_length)
        return x_t

    def repaint_final(self, known, mask, x_t, step_t, step_s, draw: Draw, jump_length: int = 1) -> torch.Tensor:
        """The last step: one reverse pass, no re-noising (the reference's
        early break, continuous_time.py:305-307)."""
        with trace.span("sampler.step", device=x_t):
            return self._repaint_reverse_jumps(
                known.to(torch.float32), mask.to(torch.float32), x_t, step_t, step_s, draw, jump_length
            )

    @torch.inference_mode()
    def repaint(
        self,
        known: torch.Tensor,
        mask: torch.Tensor,
        num_steps: int,
        num_resample_steps: int = 1,
        jump_length: int = 1,
        generator: Generators = None,
        noise: NoiseSource = None,
        device=None,
        segment_steps: Optional[int] = None,
        on_segment: OnSegment = None,
    ) -> torch.Tensor:
        """RePaint completion: ``known``/``mask`` NHWC; known pixels
        (mask = 1) are projected onto each noise level, the others follow
        the reverse process, and between resamples the state is re-noised
        forward. Draws: x_T, then per reverse sub-step the known noise and
        (Gaussian processes) the p-step noise, then the re-noise draws.
        ``segment_steps`` runs the outer loop as segments of that many
        steps, calling ``on_segment(steps_done)`` after each and after the
        final step; the result does not change."""
        check_repaint_grid(num_steps, num_resample_steps, jump_length)
        device = self._device(device)
        known = self._shard(known.to(device=device, dtype=torch.float32))
        mask = self._shard(mask.to(device=device, dtype=torch.float32))
        draw = noise_drawer(generator, noise, device, self._width())
        x_t = draw(self._rank_shape(known.shape[0]))
        ts = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32, device=device)
        ts_pairs = torch.stack([ts[:-2], ts[1:-1]], dim=1)
        seg = segment_steps or max(num_steps - 1, 1)
        for lo in range(0, num_steps - 1, seg):
            hi = min(lo + seg, num_steps - 1)
            x_t = self.repaint_segment(known, mask, x_t, ts_pairs[lo:hi], draw, num_resample_steps, jump_length)
            if on_segment is not None:
                on_segment(hi)
        x_0 = self.repaint_final(known, mask, x_t, ts[num_steps - 1], ts[num_steps], draw, jump_length)
        if on_segment is not None:
            on_segment(num_steps)
        return x_0
