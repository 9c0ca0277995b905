"""r2dm_tpu_torch: the PyTorch/CUDA port of r2dm_tpu for NVIDIA Hopper.

Imports torch, numpy and the standard library only. The JAX package
``r2dm_tpu`` is the reference the port is tested against; nothing here
imports it. The two TPU kernels of the sampling path are hand-written CUDA
kernels (``csrc/``), built with nvcc at first use on a machine with the
CUDA toolkit.
"""

from .config import Config
from .inference import DDPM, pretrained_r2dm, setup_model
from .lidar import LiDARUtility

__all__ = ["Config", "DDPM", "LiDARUtility", "pretrained_r2dm", "setup_model"]
