"""Model construction, checkpoint loading and the user-facing DDPM wrapper.

Port of ``r2dm_tpu/inference.py`` (reference ``utils/inference.py:16-114``,
``hubconf.py:21-37``): rebuild the network from the config in a checkpoint
(a reference-layout ``.pth``, or the JAX package's msgpack), load (EMA)
weights, and return a ready-to-sample :class:`DDPM` plus a matching
:class:`LiDARUtility`. ``DDPM.sample``/``DDPM.repaint`` return NCHW fp32 in
[-1, 1] like the reference; the network runs NHWC inside.

``DDPM.sample``/``DDPM.repaint`` take ``world=``, a ``parallel.World``: under
a width axis every width rank of a group runs the chain on its columns of
the same images (the same seeds), and each returns the whole images,
gathered over the group (the JAX package's ``mesh=`` on a (data, width)
mesh, r2dm_tpu/inference.py:281-292,644-653). The data axis is the caller's:
it hands each data group its own seeds.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
On the card the network runs the hand-written kernels, which compute in
bfloat16, so a CUDA model is built with ``dtype=torch.bfloat16``.
"""

from __future__ import annotations

import os
import sys
import time
import warnings
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from . import config as config_lib
from .diffusion import ContinuousTimeGaussianDiffusion, DiscreteTimeGaussianDiffusion, RectifiedFlow
from .diffusion.base import Generators, NoiseSource, check_repaint_grid
from .lidar import LiDARUtility, nearest_exact_resize_hw
from .models.efficient_unet import EfficientUNet
from .models.layers import quant_conv_mode, width_sharded
from .models.refinenet import LiDARGenRefineNet
from .ops.encoding import get_hdl64e_linear_ray_angles
from .parallel.width import gather_columns, sharded
from .utils import trace
from .utils.weights import from_jax, reference_state_dict

# the JAX package's unfolding angle tables, read in place as data
ANGLES_DIR = Path(__file__).resolve().parent.parent / "r2dm_tpu" / "data" / "angles"

PRETRAINED_CONFIGS = (
    # published reference checkpoints (reference hubconf.py:12-21)
    "r2dm-h-kitti360-300k",
    "r2dm-h-kittiraw-300k",
)


def count_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _check_dtype(device, dtype) -> None:
    if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
        raise ValueError("the CUDA kernels compute in bfloat16: pass dtype=torch.bfloat16 for a CUDA model")


def build_model(
    cfg: config_lib.Config, dtype: Optional[torch.dtype] = None, device="cuda", width_merge_l1: bool = False,
):
    """The denoiser from a Config (reference utils/inference.py:38-58):
    ``cfg.model.architecture`` "efficient_unet" or "refinenet" (JAX
    inference.py:71-81). ``width_merge_l1``: the JAX package's W2C
    latency layout, an EfficientUNet field (see ``EfficientUNet``)."""
    _check_dtype(device, dtype)
    in_channels = int(cfg.data.train_depth) + int(cfg.data.train_reflectance)
    if cfg.model.architecture == "refinenet":
        if width_merge_l1:
            raise ValueError("width_merge_l1 is an EfficientUNet-only layout")
        model = LiDARGenRefineNet(
            in_channels=in_channels,
            resolution=tuple(cfg.data.resolution),
            base_channels=cfg.model.base_channels,
            channel_multiplier=tuple(cfg.model.channel_multiplier),
            dtype=dtype,
        )
        return model.to(device).eval()
    if cfg.model.architecture != "efficient_unet":
        raise ValueError(f"unknown architecture: {cfg.model.architecture}")
    model = EfficientUNet(
        in_channels=in_channels,
        resolution=tuple(cfg.data.resolution),
        base_channels=cfg.model.base_channels,
        temb_channels=cfg.model.temb_channels,
        channel_multiplier=tuple(cfg.model.channel_multiplier),
        num_residual_blocks=tuple(cfg.model.num_residual_blocks),
        gn_num_groups=cfg.model.gn_num_groups,
        gn_eps=cfg.model.gn_eps,
        attn_num_heads=cfg.model.attn_num_heads,
        coords_encoding=cfg.model.coords_encoding,
        dtype=dtype,
        dropout=cfg.model.dropout,
        width_merge_l1=width_merge_l1,
    )
    return model.to(device).eval()


def model_coords(cfg: config_lib.Config) -> np.ndarray:
    """(H, W, 2) coordinate grid of the model buffer (reference
    train.py:100-107): HDL-64E linear ray angles for the spherical
    projection; for the unfolding projection the measured per-pixel angle
    table ``$R2DM_ANGLES_DIR/<dataset>_unfolding_angles.npz`` (default: the
    JAX package's ``r2dm_tpu/data/angles/``), resized nearest-exact."""
    resolution = tuple(cfg.data.resolution)
    if cfg.data.projection.startswith("spherical"):
        return get_hdl64e_linear_ray_angles(*resolution)
    if cfg.data.projection.startswith("unfolding"):
        angles_dir = os.environ.get("R2DM_ANGLES_DIR") or str(ANGLES_DIR)
        path = os.path.join(angles_dir, f"{cfg.data.dataset}_unfolding_angles.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"unfolding angle table not found at {path}; generate it with "
                "python -m r2dm_tpu_torch.make_unfolding_angles (requires the raw dataset) or import the "
                "reference's with python -m r2dm_tpu_torch.import_unfolding_angles"
            )
        with np.load(path) as table:
            angles = table["angles"].astype(np.float32)  # (H, W, 2)
        return nearest_exact_resize_hw(angles, resolution)
    raise ValueError(f"unknown projection: {cfg.data.projection}")


def build_diffusion(cfg: config_lib.Config, model: torch.nn.Module):
    """The configured diffusion process (reference utils/inference.py:62-78;
    r2dm_tpu/inference.py:115-140)."""
    common = dict(
        model=model,
        prediction_type=cfg.diffusion.prediction_type,
        loss_type=cfg.diffusion.loss_type,
        noise_schedule=cfg.diffusion.noise_schedule,
    )
    if cfg.diffusion.timestep_type == "continuous":
        return ContinuousTimeGaussianDiffusion(**common)
    if cfg.diffusion.timestep_type == "discrete":
        return DiscreteTimeGaussianDiffusion(num_training_steps=cfg.diffusion.num_training_steps or 1024, **common)
    if cfg.diffusion.timestep_type == "flow":
        # prediction_type and noise_schedule do not apply to the straight-path ODE
        return RectifiedFlow(model=model, loss_type=cfg.diffusion.loss_type)
    raise ValueError(f"unknown timestep type: {cfg.diffusion.timestep_type}")


def setup_rng(seeds: Sequence[int], device="cuda") -> list[torch.Generator]:
    """One generator per seed (reference utils/inference.py:113-114)."""
    return [torch.Generator(device).manual_seed(int(s)) for s in seeds]


class _Progress:
    """A stderr line after each chunk of a chain: steps done, and the rate
    and time left measured from the end of the first chunk."""

    def __init__(self, label: str, total: int, show: bool, device: torch.device):
        self.label, self.total, self.show, self.device = label, total, show, device
        self.t0, self.timed_from = time.time(), None

    def update(self, done: int) -> None:
        if not self.show:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.timed_from is None:
            self.t0, self.timed_from = time.time(), done
        msg = f"\r{self.label} {done}/{self.total} steps"
        if done > self.timed_from:
            rate = (done - self.timed_from) / max(time.time() - self.t0, 1e-9)
            msg += f" ({rate:.1f} step/s, eta {(self.total - done) / max(rate, 1e-9):.0f}s)"
        print(msg, end="" if done < self.total else "\n", file=sys.stderr, flush=True)


class DDPM:
    """The diffusion process bound to its network, with the reference's
    sampling surface. Per-sample determinism: ``seeds=[...]`` gives each
    row its own generator (the reference's list of torch.Generators)."""

    # Batch-axis chunking bound, in pixels (batch x H x W) per card; larger
    # batches run as sequential chunks. Rule: the largest power of two of
    # 64x1024 images n with n x m <= 0.7 x the card's memory, m the larger
    # per-image peak of one sampling step and one RePaint step at config H
    # (chip_smoke.py: torch.cuda.max_memory_allocated at b8 and b32). On an
    # NVIDIA H100 80GB HBM3, 700.00 W: m = 114.3 MB (a RePaint step; a
    # DDIM step 112.7 MB), so 0.7 x 85.0 GB / m = 520.9 and n = 512
    # (58.5 GB).
    MAX_BATCH_PIXELS = 512 * 64 * 1024
    # Under the int8 lane the JAX package's bounds (r2dm_tpu/inference.py:
    # 396-397: a batch over 384 images runs as chunks of 256): one
    # activation scale covers a whole chunk, so an int8 sample depends on
    # the samples it is chunked with, and the port chunks as JAX does.
    INT8_MAX_BATCH_PIXELS = 384 * 64 * 1024
    INT8_BATCH_CHUNK_PIXELS = 256 * 64 * 1024

    def __init__(self, diffusion, cfg: Optional[config_lib.Config] = None):
        self.diffusion = diffusion
        self.cfg = cfg
        self.num_parameters = count_parameters(diffusion.model)
        self._auto_calls = 0

    @property
    def model(self) -> torch.nn.Module:
        return self.diffusion.model

    @property
    def device(self) -> torch.device:
        return self.model.coords.device

    @property
    def sampling_shape(self):
        return self.diffusion.sampling_shape

    @property
    def coords(self) -> torch.Tensor:
        """The network's (H, W, 2) coordinate buffer, in the JAX package's
        layout (r2dm_tpu/inference.py:186-190)."""
        return self.model.coords[0].permute(1, 2, 0)

    def _generators(self, seeds: Optional[Sequence[int]]) -> Generators:
        if seeds is not None:
            return setup_rng(seeds, self.device)
        # no explicit randomness: advance an internal stream so repeated
        # calls give fresh batches. Every rank of a group would start that
        # stream alike and return the same batch (JAX inference.py:202-211)
        if torch.distributed.is_available() and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            raise ValueError(
                "multi-host sampling needs an explicit key= or seeds= "
                "(the implicit per-process rng stream would desynchronize)"
            )
        self._auto_calls += 1
        return torch.Generator(self.device).manual_seed(self._auto_calls)

    def _batch_chunk(self, batch_size: int, batch_chunk: Optional[int], seeds, width_size: int = 1) -> int:
        """Images per chunk: ``batch_chunk``, or the pixel bound's when the
        batch is over it. The bound counts a card's pixels: under a width
        axis of ``width_size`` ranks each card holds that share of an image
        (JAX inference.py:281-292)."""
        if batch_chunk is not None:
            if batch_chunk < 1:
                raise ValueError(f"batch_chunk must be >= 1, got {batch_chunk}")
            return batch_chunk
        hw = int(np.prod(self.sampling_shape[:-1])) // width_size
        bound, chunk = self.MAX_BATCH_PIXELS, self.MAX_BATCH_PIXELS
        if quant_conv_mode(self.model) is not None:
            bound, chunk = self.INT8_MAX_BATCH_PIXELS, self.INT8_BATCH_CHUNK_PIXELS
        if batch_size * hw <= bound:
            return batch_size
        if seeds is None:
            warnings.warn(
                "batch auto-chunking with a single generator: samples depend on "
                "the chunk boundary; pass seeds=[...] for chunking-invariant "
                "determinism",
                stacklevel=3,
            )
        return max(1, chunk // hw)

    def _check_mode(self, mode: str) -> None:
        is_flow = isinstance(self.diffusion, RectifiedFlow)
        if mode == "dpmpp_2m" and (is_flow or isinstance(self.diffusion, DiscreteTimeGaussianDiffusion)):
            raise ValueError(
                "mode='dpmpp_2m' requires continuous-time diffusion "
                "(the solver integrates the logSNR-parameterized PF-ODE)"
            )
        if (mode in ("euler", "midpoint")) != is_flow:
            raise ValueError(
                f"mode={mode!r} does not apply to "
                f"{type(self.diffusion).__name__}: flow checkpoints sample "
                "with 'euler'/'midpoint', Gaussian ones with "
                "'ddpm'/'ddim'/'dpmpp_2m'"
            )

    def sample(
        self,
        batch_size: int,
        num_steps: int,
        seeds: Optional[Sequence[int]] = None,
        mode: str = "ddpm",
        ddim_eta: float = 0.0,
        return_all: bool = False,
        data_format: str = "NCHW",
        progress: bool = False,
        progress_chunk: int = 32,
        batch_chunk: Optional[int] = None,
        x_T: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        world=None,
    ) -> torch.Tensor:
        """Generate scans: (B, C, H, W) fp32 (NCHW) or (B, H, W, C) (NHWC);
        with ``return_all`` every step too, (num_steps+1, B, ...).

        Modes: ``ddpm``/``ddim`` (Gaussian processes), ``dpmpp_2m``
        (continuous-time), ``euler``/``midpoint`` (flow). ``progress`` prints
        a line to stderr every ``progress_chunk`` steps; the samples do not
        change. A batch over ``MAX_BATCH_PIXELS`` runs as sequential chunks,
        and ``batch_chunk`` forces a chunk size; with ``seeds`` the result
        does not depend on the chunking. ``x_T`` (B, H, W, C) and ``noise``
        (num_steps, B, H, W, C), NHWC, replace the generators' draws.
        ``world``: under its width axis this rank runs its columns of the
        chain (``_width``) and returns the whole scans, gathered over the
        width group, on every width rank of it.
        """
        self._check_mode(mode)
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, got {data_format!r}")
        if seeds is not None and len(seeds) != batch_size:
            raise ValueError(f"{len(seeds)} seeds for a batch of {batch_size}")
        if progress_chunk < 1:
            raise ValueError(f"progress_chunk must be >= 1, got {progress_chunk}")
        width = self._width(world)
        chunk = self._batch_chunk(batch_size, batch_chunk, seeds, width.width_size if width else 1)
        with trace.span("entry.sample", device=self.model.coords, request=True):
            gens = self._generators(seeds)
            outs = []
            with width_sharded(self.model, width):
                for lo in range(0, batch_size, chunk):
                    hi = min(lo + chunk, batch_size)
                    x = self._chain(
                        hi - lo, num_steps, mode, ddim_eta,
                        gens if isinstance(gens, torch.Generator) else gens[lo:hi],
                        None if x_T is None else x_T[lo:hi],
                        None if noise is None else noise[:, lo:hi],
                        return_all, progress, progress_chunk,
                    )
                    outs.append(gather_columns(x, width, dim=3 if return_all else 2))
            x = torch.cat(outs, dim=1 if return_all else 0)
            if data_format == "NCHW":
                x = x.permute(0, 1, 4, 2, 3) if return_all else x.permute(0, 3, 1, 2)
                x = x.contiguous()
        return x

    def _width(self, world):
        """``world`` when it splits the columns (the model's levels must
        split: its ``check_width_shard`` raises), else None."""
        if not sharded(world):
            return None
        self.model.check_width_shard(world.width_size)
        return world

    def _chain(self, B, num_steps, mode, ddim_eta, gens, x_T, noise, return_all, show, chunk) -> torch.Tensor:
        """One batch chunk's reverse chain, NHWC: the diffusion's own chain,
        run as segments of ``chunk`` steps with a progress line between
        them when ``show`` (the same operations either way)."""
        diff = self.diffusion
        bar = _Progress("sampling", num_steps, show, self.device)
        common = dict(generator=gens, x_T=x_T, device=self.device, return_all=return_all,
                      segment_steps=chunk if show else None, on_segment=bar.update)
        if mode == "dpmpp_2m":
            return diff.sample_dpmpp(B, num_steps, **common)
        eta = {"eta" if isinstance(diff, DiscreteTimeGaussianDiffusion) else "ddim_eta": ddim_eta}
        return diff.sample(B, num_steps, mode=mode, noise=noise, **eta, **common)

    def repaint(
        self,
        known: torch.Tensor,
        mask: torch.Tensor,
        num_steps: int,
        num_resample_steps: int = 1,
        jump_length: int = 1,
        seeds: Optional[Sequence[int]] = None,
        data_format: str = "NCHW",
        progress: bool = False,
        progress_chunk: int = 32,
        noise: NoiseSource = None,
        world=None,
    ) -> torch.Tensor:
        """RePaint completion; ``known``/``mask`` batched in ``data_format``
        (reference continuous_time.py:260-317, completion_demo.py:92-99).
        ``mask`` has known's rank and a batch of 1 (broadcast) or known's.
        Continuous-time and flow checkpoints only, as in the reference.
        ``progress`` prints a line per chunk of about ``progress_chunk``
        network calls. ``noise``, a callable ``shape -> tensor`` or an
        iterator, replaces the generators' draws, taken in the order x_T,
        then per reverse sub-step the known noise and (continuous) the
        p-step noise, then the re-noise draws (each the whole image's).
        ``world``: as in :meth:`sample`; ``known`` and ``mask`` are the whole
        images, cut to the rank's columns."""
        if isinstance(self.diffusion, DiscreteTimeGaussianDiffusion):
            raise ValueError(
                "repaint requires a continuous-time or flow checkpoint; the "
                "discrete-time family does not implement the RePaint hooks "
                "(reference parity: repaint exists in continuous_time.py "
                "only)"
            )
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, got {data_format!r}")
        known = torch.as_tensor(known)
        mask = torch.as_tensor(mask)
        if mask.dim() != known.dim():
            raise ValueError(
                f"mask must have the same rank as known (batched, "
                f"{data_format}); got mask {tuple(mask.shape)} vs known {tuple(known.shape)}"
            )
        if mask.shape[0] not in (1, known.shape[0]):
            raise ValueError(
                f"mask batch dim must be 1 (broadcast) or match known's "
                f"{known.shape[0]}; got {mask.shape[0]}"
            )
        check_repaint_grid(num_steps, num_resample_steps, jump_length)
        bsz = int(known.shape[0])
        if seeds is not None and len(seeds) != bsz:
            raise ValueError(f"{len(seeds)} seeds for a batch of {bsz}")
        if data_format == "NCHW":
            known, mask = known.permute(0, 2, 3, 1), mask.permute(0, 2, 3, 1)
        device = self.device
        known = known.to(device=device, dtype=torch.float32)
        mask = mask.to(device=device, dtype=torch.float32)
        width = self._width(world)
        chunk = self._batch_chunk(bsz, None, seeds, width.width_size if width else 1)
        # with a progress line, segments of about progress_chunk network calls
        segment = max(1, progress_chunk // (num_resample_steps * jump_length)) if progress else None
        with trace.span("entry.sample", device=known, request=True):
            gens = self._generators(seeds)
            outs = []
            with width_sharded(self.model, width):
                for lo in range(0, bsz, chunk):
                    hi = min(lo + chunk, bsz)
                    bar = _Progress("repaint", num_steps, progress, device)
                    outs.append(gather_columns(self.diffusion.repaint(
                        known[lo:hi], mask[lo:hi] if mask.shape[0] == bsz else mask, num_steps,
                        num_resample_steps, jump_length,
                        generator=gens if isinstance(gens, torch.Generator) else gens[lo:hi],
                        noise=noise, device=device, segment_steps=segment, on_segment=bar.update,
                    ), width))
            x = torch.cat(outs)
            return x.permute(0, 3, 1, 2).contiguous() if data_format == "NCHW" else x

    def loss(self, x_0: torch.Tensor, generator: Generators = None, data_format: str = "NHWC") -> torch.Tensor:
        """The training loss of the diffusion on ``x_0`` (JAX
        inference.py:743-746): timesteps and noise from ``generator``
        (default: the internal stream of ``sample``), NHWC or NCHW input."""
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, got {data_format!r}")
        x_0 = torch.as_tensor(x_0).to(self.device)
        if data_format == "NCHW":
            x_0 = x_0.permute(0, 2, 3, 1)
        if generator is None:
            generator = self._generators(None)
        return self.diffusion.loss(self.model, x_0, generator)


def _load(path: str) -> dict:
    if path.endswith((".pth", ".pt", ".ckpt")):
        return torch.load(path, map_location="cpu", weights_only=False)
    from .checkpoint import load_checkpoint

    return load_checkpoint(path)


def load_config(ckpt) -> config_lib.Config:
    """The Config a checkpoint (a path, or an already-loaded dict) carries,
    without building the network."""
    if isinstance(ckpt, (str, os.PathLike)):
        ckpt = _load(str(ckpt))
    return config_lib.from_dict(ckpt["cfg"]) if isinstance(ckpt.get("cfg"), dict) else ckpt["cfg"]


def setup_model(
    ckpt, ema: bool = True, dtype: Optional[torch.dtype] = None, device="cuda", width_merge_l1: bool = False,
) -> tuple[DDPM, LiDARUtility, config_lib.Config]:
    """Rebuild (ddpm, lidar_utils, cfg) from a checkpoint: a reference-layout
    ``.pth``/``.pt``/``.ckpt``, any other path as the JAX package's msgpack
    checkpoint (``checkpoint.py``), or an already-loaded dict {cfg, weights,
    ema_weights, ...} of either kind (reference utils/inference.py:16-114).
    ``width_merge_l1``: the small-batch latency layout (``build_model``)."""
    with trace.span("entry.setup_model"):
        if isinstance(ckpt, (str, os.PathLike)):
            ckpt = _load(str(ckpt))
        _check_dtype(device, dtype)
        cfg = load_config(ckpt)
        with trace.span("entry.build"):
            model = build_model(cfg, dtype=dtype, device="cpu", width_merge_l1=width_merge_l1)
        with trace.span("entry.load_weights"):
            weights = ckpt.get("ema_weights" if ema else "weights") or ckpt.get("weights")
            if "params" in weights:  # a flax tree {'params', 'buffers'}
                sd = from_jax(weights, cfg.model.architecture)
            else:
                sd = reference_state_dict(weights)
            if "coords" not in sd:
                # the EfficientUNet's grid is the sensor's ray angles; a RefineNet
                # keeps its own [0, 1] grid, as the flax module's buffer does
                sd["coords"] = (torch.from_numpy(np.ascontiguousarray(model_coords(cfg).transpose(2, 0, 1)[None]))
                                if cfg.model.architecture == "efficient_unet" else model.coords)
            model.load_state_dict(sd)
        with trace.span("entry.to_device"):
            model = model.to(device)
        ddpm = DDPM(build_diffusion(cfg, model), cfg)
        lidar_utils = LiDARUtility(
            resolution=tuple(cfg.data.resolution),
            depth_format=cfg.data.depth_format,
            min_depth=cfg.data.min_depth,
            max_depth=cfg.data.max_depth,
            ray_angles=model.coords,
            data_format="NCHW",
            device=model.coords.device,
        )
    return ddpm, lidar_utils, cfg


def pretrained_r2dm(
    config: str = "r2dm-h-kitti360-300k",
    ckpt_path: Optional[str] = None,
    ema: bool = True,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
    width_merge_l1: bool = False,
) -> tuple[DDPM, LiDARUtility, config_lib.Config]:
    """The hub entry point (reference hubconf.py:21-37): ``ckpt_path``, else
    ``config`` resolved by :func:`resolve_pretrained_ckpt`."""
    if ckpt_path is None:
        ckpt_path = resolve_pretrained_ckpt(config)
    return setup_model(ckpt_path, ema=ema, dtype=dtype, device=device, width_merge_l1=width_merge_l1)


# the release URL scheme (reference hubconf.py:17-18); $R2DM_WEIGHTS_URL_BASE
# overrides the base (file:// URLs work)
WEIGHTS_URL_BASE = "https://github.com/kazuto1011/r2dm/releases/download/weights"


def resolve_pretrained_ckpt(config: str, progress: bool = True) -> str:
    """A config name -> a local ``.pth`` path, as the JAX package resolves
    it (r2dm_tpu/inference.py:860-906): ``$R2DM_CKPT_DIR/<config>.pth``,
    else ``<cache>/checkpoints/<config>.pth`` with the cache
    ``$R2DM_CACHE_DIR`` (default ``~/.cache/r2dm_tpu``, where the JAX package
    downloads to), else a fetch of ``<base>/<config>.pth`` into
    ``<cache file>.tmp``, renamed into place. A failed fetch removes the
    ``.tmp`` file and raises FileNotFoundError naming both remedies."""
    ckpt_dir = os.environ.get("R2DM_CKPT_DIR", "")
    if ckpt_dir:
        candidate = os.path.join(ckpt_dir, f"{config}.pth")
        if os.path.exists(candidate):
            return candidate
    cache_dir = os.environ.get("R2DM_CACHE_DIR", os.path.expanduser("~/.cache/r2dm_tpu"))
    cached = os.path.join(cache_dir, "checkpoints", f"{config}.pth")
    if os.path.exists(cached):
        return cached
    url = f"{os.environ.get('R2DM_WEIGHTS_URL_BASE', WEIGHTS_URL_BASE)}/{config}.pth"
    import urllib.error
    import urllib.request

    os.makedirs(os.path.dirname(cached), exist_ok=True)
    tmp = cached + ".tmp"
    try:
        if progress:
            print(f"downloading {url} -> {cached}")
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, cached)  # atomic: an interrupted fetch leaves no torn file
        return cached
    except (urllib.error.URLError, OSError, ValueError) as e:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise FileNotFoundError(
            f"checkpoint for '{config}' not found locally and the download "
            f"from {url} failed ({e}); download it manually from "
            "https://github.com/kazuto1011/r2dm/releases and pass "
            "ckpt_path= or set $R2DM_CKPT_DIR"
        ) from e
