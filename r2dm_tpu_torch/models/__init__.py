from .efficient_unet import EfficientUNet
from .refinenet import LiDARGenRefineNet

__all__ = ["EfficientUNet", "LiDARGenRefineNet"]
