"""Training: step builders and the dispatch-ahead driver."""

from blendjax_torch.train.driver import TrainDriver
from blendjax_torch.train.steps import (
    TrainState,
    corner_loss,
    make_chunked_supervised_step,
    make_echo_fused_step,
    make_fused_tile_step,
    make_supervised_step,
    make_train_state,
)

__all__ = [
    "TrainDriver",
    "TrainState",
    "corner_loss",
    "make_chunked_supervised_step",
    "make_echo_fused_step",
    "make_fused_tile_step",
    "make_supervised_step",
    "make_train_state",
]
