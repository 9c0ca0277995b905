"""Model construction, checkpoint loading and the user-facing DDPM wrapper.

Port of the sampling surface of ``r2dm_tpu/inference.py`` (reference
``utils/inference.py:16-114``, ``hubconf.py:21-37``): rebuild the network
from the config in a reference-layout checkpoint, load (EMA) weights, and
return a ready-to-sample :class:`DDPM` plus a matching
:class:`LiDARUtility`. ``DDPM.sample`` returns NCHW fp32 in [-1, 1] like the
reference; the network runs NHWC inside.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
On the card the network runs the hand-written kernels, which compute in
bfloat16, so a CUDA model is built with ``dtype=torch.bfloat16``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from . import config as config_lib
from .diffusion import ContinuousTimeGaussianDiffusion
from .diffusion.base import Generators
from .lidar import LiDARUtility
from .models.efficient_unet import EfficientUNet
from .ops.encoding import get_hdl64e_linear_ray_angles
from .utils.weights import reference_unet_state_dict


def count_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _check_dtype(device, dtype) -> None:
    if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
        raise ValueError("the CUDA kernels compute in bfloat16: pass dtype=torch.bfloat16 for a CUDA model")


def build_model(cfg: config_lib.Config, dtype: Optional[torch.dtype] = None, device="cuda") -> EfficientUNet:
    """The denoiser from a Config (reference utils/inference.py:38-58)."""
    if cfg.model.architecture != "efficient_unet":
        raise NotImplementedError(f"architecture {cfg.model.architecture!r} is not ported yet")
    _check_dtype(device, dtype)
    model = EfficientUNet(
        in_channels=int(cfg.data.train_depth) + int(cfg.data.train_reflectance),
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
    )
    return model.to(device).eval()


def model_coords(cfg: config_lib.Config) -> np.ndarray:
    """(H, W, 2) coordinate grid of the model buffer: HDL-64E linear ray
    angles for the spherical projection (reference train.py:100-107)."""
    if cfg.data.projection.startswith("spherical"):
        return get_hdl64e_linear_ray_angles(*tuple(cfg.data.resolution))
    raise NotImplementedError(f"projection {cfg.data.projection!r} is not ported yet")


def build_diffusion(cfg: config_lib.Config, model: EfficientUNet) -> ContinuousTimeGaussianDiffusion:
    """The configured diffusion process (reference utils/inference.py:62-78)."""
    if cfg.diffusion.timestep_type != "continuous":
        raise NotImplementedError(f"timestep_type {cfg.diffusion.timestep_type!r} is not ported yet")
    return ContinuousTimeGaussianDiffusion(
        model,
        prediction_type=cfg.diffusion.prediction_type,
        loss_type=cfg.diffusion.loss_type,
        noise_schedule=cfg.diffusion.noise_schedule,
    )


class DDPM:
    """The diffusion process bound to its network, with the reference's
    sampling surface. Per-sample determinism: ``seeds=[...]`` gives each
    row its own generator (the reference's list of torch.Generators)."""

    def __init__(self, diffusion: ContinuousTimeGaussianDiffusion, cfg: Optional[config_lib.Config] = None):
        self.diffusion = diffusion
        self.cfg = cfg
        self.num_parameters = count_parameters(diffusion.model)
        self._auto_calls = 0

    @property
    def model(self) -> EfficientUNet:
        return self.diffusion.model

    @property
    def device(self) -> torch.device:
        return self.model.coords.device

    @property
    def sampling_shape(self):
        return self.diffusion.sampling_shape

    def _generators(self, seeds: Optional[Sequence[int]]) -> Generators:
        if seeds is not None:
            return [torch.Generator(self.device).manual_seed(int(s)) for s in seeds]
        # no explicit randomness: advance an internal stream so repeated
        # calls give fresh batches
        self._auto_calls += 1
        return torch.Generator(self.device).manual_seed(self._auto_calls)

    def sample(
        self,
        batch_size: int,
        num_steps: int,
        seeds: Optional[Sequence[int]] = None,
        mode: str = "ddpm",
        ddim_eta: float = 0.0,
        data_format: str = "NCHW",
        batch_chunk: Optional[int] = None,
        x_T: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Generate scans: (B, C, H, W) fp32 (NCHW) or (B, H, W, C) (NHWC).

        ``batch_chunk`` runs the batch as sequential chunks of that many
        images; with ``seeds`` the result does not depend on the chunking.
        ``x_T`` (B, H, W, C) and ``noise`` (num_steps, B, H, W, C), NHWC,
        replace the generators' draws.
        """
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, got {data_format!r}")
        if seeds is not None and len(seeds) != batch_size:
            raise ValueError(f"{len(seeds)} seeds for a batch of {batch_size}")
        if batch_chunk is not None and batch_chunk < 1:
            raise ValueError(f"batch_chunk must be >= 1, got {batch_chunk}")
        gens = self._generators(seeds)
        chunk = batch_size if batch_chunk is None else batch_chunk
        outs = []
        for lo in range(0, batch_size, chunk):
            hi = min(lo + chunk, batch_size)
            outs.append(self.diffusion.sample(
                hi - lo, num_steps, mode=mode, ddim_eta=ddim_eta,
                generator=gens if isinstance(gens, torch.Generator) else gens[lo:hi],
                x_T=None if x_T is None else x_T[lo:hi],
                noise=None if noise is None else noise[:, lo:hi],
                device=self.device,
            ))
        x = torch.cat(outs)
        return x.permute(0, 3, 1, 2).contiguous() if data_format == "NCHW" else x


def setup_model(
    ckpt, ema: bool = True, dtype: Optional[torch.dtype] = None, device="cuda",
) -> tuple[DDPM, LiDARUtility, config_lib.Config]:
    """Rebuild (ddpm, lidar_utils, cfg) from a reference-layout checkpoint:
    a ``.pth`` path or an already-loaded dict {cfg, weights, ema_weights,
    ...} (reference utils/inference.py:16-114)."""
    if isinstance(ckpt, (str, os.PathLike)):
        path = str(ckpt)
        if not path.endswith((".pth", ".pt", ".ckpt")):
            raise ValueError(f"{path}: the port reads reference-layout .pth checkpoints")
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    _check_dtype(device, dtype)
    cfg = config_lib.from_dict(ckpt["cfg"]) if isinstance(ckpt.get("cfg"), dict) else ckpt["cfg"]
    weights = ckpt.get("ema_weights" if ema else "weights") or ckpt.get("weights")
    model = build_model(cfg, dtype=dtype, device="cpu")
    model.load_state_dict(reference_unet_state_dict(weights))
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
) -> tuple[DDPM, LiDARUtility, config_lib.Config]:
    """The hub entry point (reference hubconf.py:21-37): ``ckpt_path``, else
    ``$R2DM_CKPT_DIR/<config>.pth``. Nothing is downloaded."""
    if ckpt_path is None:
        ckpt_dir = os.environ.get("R2DM_CKPT_DIR", "")
        candidate = os.path.join(ckpt_dir, f"{config}.pth")
        if not ckpt_dir or not os.path.exists(candidate):
            raise FileNotFoundError(
                f"checkpoint for {config!r} not found: pass ckpt_path= or put "
                f"{config}.pth in $R2DM_CKPT_DIR"
            )
        ckpt_path = candidate
    return setup_model(ckpt_path, ema=ema, dtype=dtype, device=device)
