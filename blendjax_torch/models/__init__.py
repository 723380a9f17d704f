"""Models of the port."""

from blendjax_torch.models.cnn import CubeRegressor
from blendjax_torch.models.transformer import (
    Block,
    LayerNorm,
    MultiHeadAttention,
    StreamFormer,
)

__all__ = ["Block", "CubeRegressor", "LayerNorm", "MultiHeadAttention",
           "StreamFormer"]
