from .efficient_unet import EfficientUNet

__all__ = ["EfficientUNet"]
