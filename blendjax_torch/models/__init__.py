"""Models of the port."""

from blendjax_torch.models.cnn import CubeRegressor
from blendjax_torch.models.discriminator import Discriminator
from blendjax_torch.models.moe import MoEMLP, apply_with_aux, collect_aux_loss
from blendjax_torch.models.policy import PolicyValueNet, QNetwork
from blendjax_torch.models.transformer import (
    Block,
    LayerNorm,
    MultiHeadAttention,
    StreamFormer,
)

__all__ = ["Block", "CubeRegressor", "Discriminator", "LayerNorm", "MoEMLP",
           "MultiHeadAttention", "PolicyValueNet", "QNetwork", "StreamFormer",
           "apply_with_aux", "collect_aux_loss"]
