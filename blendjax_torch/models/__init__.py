"""Models of the port."""

from blendjax_torch.models.cnn import CubeRegressor

__all__ = ["CubeRegressor"]
