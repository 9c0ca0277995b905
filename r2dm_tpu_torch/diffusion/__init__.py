from .continuous import ContinuousTimeGaussianDiffusion

__all__ = ["ContinuousTimeGaussianDiffusion"]
