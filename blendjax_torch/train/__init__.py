"""Training: step builders, captured step graphs and the dispatch-ahead
driver."""

from blendjax_torch.train.aot import (
    AotStepSet,
    CapturedDispatch,
    CapturedStep,
    batch_specs_for_ladder,
    build_aot_step,
    cache_key,
    configure_compilation_cache,
)
from blendjax_torch.train.checkpoint import CheckpointManager
from blendjax_torch.train.driver import TrainDriver
from blendjax_torch.train.mesh_driver import (
    MeshTrainDriver,
    make_mesh_echo_fused_step,
    make_mesh_fused_step,
    make_mesh_supervised_step,
)
from blendjax_torch.train.steps import (
    TrainState,
    corner_loss,
    make_chunked_supervised_step,
    make_echo_fused_step,
    make_eval_step,
    make_fused_tile_step,
    make_supervised_step,
    make_train_state,
)

__all__ = [
    "AotStepSet",
    "CapturedDispatch",
    "CapturedStep",
    "CheckpointManager",
    "MeshTrainDriver",
    "TrainDriver",
    "TrainState",
    "batch_specs_for_ladder",
    "build_aot_step",
    "cache_key",
    "configure_compilation_cache",
    "corner_loss",
    "make_chunked_supervised_step",
    "make_echo_fused_step",
    "make_eval_step",
    "make_fused_tile_step",
    "make_mesh_echo_fused_step",
    "make_mesh_fused_step",
    "make_mesh_supervised_step",
    "make_supervised_step",
    "make_train_state",
]
