from .continuous import ContinuousTimeGaussianDiffusion
from .discrete import DiscreteTimeGaussianDiffusion
from .flow import RectifiedFlow

__all__ = ["ContinuousTimeGaussianDiffusion", "DiscreteTimeGaussianDiffusion", "RectifiedFlow"]
