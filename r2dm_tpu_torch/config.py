"""Configuration for the PyTorch port, as stdlib dataclasses.

The same ``{data, model, diffusion, training}`` fields and defaults as
``r2dm_tpu/config.py`` (which mirrors the reference ``utils/option.py``), so a
checkpoint's embedded ``cfg`` dict rebuilds the same network here. The
defaults are config H. ``from_dict`` drops unknown keys, as the JAX package
does, so reference checkpoints without the TPU-only fields load cleanly.
``parse_cli`` reads the nested ``--data.x/--model.y/--diffusion.z/
--training.w`` flags of the JAX package's ``config.parse_cli``.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class ModelConfig:
    architecture: str = "efficient_unet"
    base_channels: int = 64
    temb_channels: Optional[int] = None
    channel_multiplier: Tuple[int, int, int, int] = (1, 2, 4, 8)
    num_residual_blocks: Tuple[int, int, int, int] = (3, 3, 3, 3)
    gn_num_groups: int = 32 // 4
    gn_eps: float = 1e-6
    attn_num_heads: int = 8
    coords_encoding: Optional[str] = "fourier_features"
    dropout: float = 0.0


@dataclass
class DiffusionConfig:
    num_training_steps: Optional[int] = None
    num_sampling_steps: int = 1024
    prediction_type: str = "eps"
    loss_type: str = "l2"
    noise_schedule: str = "cosine"
    timestep_type: str = "continuous"


@dataclass
class TrainingConfig:
    batch_size_train: int = 8
    batch_size_eval: int = 8
    num_workers: int = 4
    num_steps: int = 300_000
    steps_save_image: int = 5_000
    steps_save_model: int = 10_000
    gradient_accumulation_steps: int = 1
    lr: float = 1e-4
    lr_warmup_steps: int = 10_000
    adam_beta1: float = 0.9
    adam_beta2: float = 0.99
    adam_weight_decay: float = 0.0
    adam_epsilon: float = 1e-8
    ema_decay: float = 0.995
    ema_update_every: int = 10
    mixed_precision: str = "bf16"
    output_dir: str = "logs/diffusion"
    seed: int = 0
    mesh_shape: Optional[Tuple[int, ...]] = None
    resume: Optional[str] = None
    profile_dir: Optional[str] = None
    max_host_rss_gb: Optional[float] = 96.0
    width_merge_l1: bool = True
    gn_bf16: bool = True
    grad_bf16: bool = False


@dataclass
class DataConfig:
    dataset: str = "kitti_360"
    depth_format: str = "log_depth"
    projection: str = "spherical-1024"
    train_depth: bool = True
    train_reflectance: bool = True
    resolution: Tuple[int, int] = (64, 1024)
    min_depth: float = 1.45
    max_depth: float = 80.0
    data_root: Optional[str] = None


@dataclass
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)


_CHOICES = {
    ("model", "coords_encoding"): (
        None, "spherical_harmonics", "polar_coordinates", "fourier_features",
    ),
    ("diffusion", "prediction_type"): ("eps", "v", "x_0"),
    ("diffusion", "timestep_type"): ("continuous", "discrete", "flow"),
    ("data", "dataset"): ("kitti_raw", "kitti_360", "synthetic"),
    ("data", "depth_format"): ("log_depth", "inverse_depth", "depth"),
}


def asdict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)


def _section(cls, group: str, sub: dict):
    """Known keys of one section; lists become tuples (a checkpoint written
    through JSON or msgpack carries tuples as lists)."""
    names = {f.name for f in dataclasses.fields(cls)}
    kept = {}
    for k, v in sub.items():
        if k not in names:
            continue
        if isinstance(v, list):
            v = tuple(v)
        choices = _CHOICES.get((group, k))
        if choices is not None and v not in choices:
            raise ValueError(f"{group}.{k}={v!r} is not one of {choices}")
        kept[k] = v
    return cls(**kept)


def from_dict(d: dict) -> Config:
    """Rebuild a Config from a (possibly reference-checkpoint) dict."""
    return Config(
        data=_section(DataConfig, "data", d.get("data", {})),
        model=_section(ModelConfig, "model", d.get("model", {})),
        diffusion=_section(DiffusionConfig, "diffusion", d.get("diffusion", {})),
        training=_section(TrainingConfig, "training", d.get("training", {})),
    )


def _add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix: str) -> None:
    """One ``--<prefix>.<field>`` flag per field, typed by its default: bools
    from 1/true/yes, tuples of ints split on commas or spaces, and the word
    None for an optional field."""
    for f in dataclasses.fields(cls):
        arg = f"--{prefix}.{f.name}"
        default = f.default
        if default is None and "Tuple" in str(f.type):  # mesh_shape: None, or ints split on commas or spaces
            parser.add_argument(arg, type=lambda s: None if s == "None" else tuple(
                int(x) for x in s.replace(",", " ").split()), default=default)
        elif isinstance(default, bool):
            parser.add_argument(arg, type=lambda s: s.lower() in ("1", "true", "yes"), default=default)
        elif isinstance(default, tuple):
            parser.add_argument(
                arg, type=lambda s: tuple(int(x) for x in s.replace(",", " ").split()), default=default
            )
        elif isinstance(default, int):
            parser.add_argument(arg, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(arg, type=float, default=default)
        else:
            parser.add_argument(arg, type=lambda s: None if s == "None" else s, default=default)


def parse_cli(argv=None, parser: argparse.ArgumentParser = None) -> tuple[Config, argparse.Namespace]:
    """The nested config flags (r2dm_tpu/config.py:166-204, reference
    train.py:315-318), added to ``parser`` (a new one by default, so a
    caller can add its own flags). Returns the Config and the namespace."""
    parser = parser or argparse.ArgumentParser()
    for cls, group in ((DataConfig, "data"), (ModelConfig, "model"), (DiffusionConfig, "diffusion"),
                       (TrainingConfig, "training")):
        _add_dataclass_args(parser, cls, group)
    ns = parser.parse_args(argv)
    sub = {"data": {}, "model": {}, "diffusion": {}, "training": {}}
    for k, v in vars(ns).items():
        if "." not in k:
            continue
        group, name = k.split(".", 1)
        sub[group][name] = v
    return from_dict(sub), ns
