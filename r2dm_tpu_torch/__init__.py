"""r2dm_tpu_torch: the PyTorch/CUDA port of r2dm_tpu for NVIDIA Hopper.

Imports torch, numpy and the standard library only. The JAX package
``r2dm_tpu`` is the reference the port is tested against; nothing here
imports it. The two TPU kernels, which every sampler runs, are hand-written
CUDA kernels (``csrc/``), built with nvcc at first use on a machine with the
CUDA toolkit; under autograd the training step runs them too.
The command-line entry points are ``python -m r2dm_tpu_torch.<name>`` for
``generate``, ``bench``, ``train``, ``sample_and_save``, ``evaluate`` and
``completion_demo``.
"""

from .config import Config
from .inference import DDPM, PRETRAINED_CONFIGS, pretrained_r2dm, setup_model, setup_rng
from .lidar import LiDARUtility

__all__ = ["Config", "DDPM", "LiDARUtility", "PRETRAINED_CONFIGS", "pretrained_r2dm", "setup_model", "setup_rng"]
