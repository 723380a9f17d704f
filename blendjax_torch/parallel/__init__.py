"""Multi-GPU parallelism on ``torch.distributed`` (port of
``blendjax/parallel``): device meshes, shardings, partition rules and
layouts, collectives over a named axis, and sequence parallelism (ring
and Ulysses attention) and GPipe pipeline parallelism (:mod:`.pipeline`).

One process per card: the JAX package drives every device from one
process, the port runs one process per card, so its mesh path is the JAX
package's multi-host form even on one host (:mod:`.mesh`).
"""

from blendjax_torch.parallel.collectives import (
    all_gather,
    all_reduce_mean,
    all_reduce_sum,
    all_to_all,
    ring_permute,
    scatter_to_axis,
)
from blendjax_torch.parallel.mesh import MeshSpec, create_mesh
from blendjax_torch.parallel.pipeline import pipeline_apply, stack_stage_params
from blendjax_torch.parallel.ring import ring_attention
from blendjax_torch.parallel.sharding import (
    DEFAULT_TP_RULES,
    LAYOUTS,
    Layout,
    PartitionRule,
    ShardedParams,
    Sharding,
    batch_sharding,
    leading_shard_count,
    mesh_chip_count,
    param_sharding_rules,
    replicated,
    resolve_layout,
    resolve_rules,
    ring_sharding,
    shard_params,
    state_resident_bytes,
    state_shardings,
    validate_batch_sharding,
)
from blendjax_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "DEFAULT_TP_RULES",
    "LAYOUTS",
    "Layout",
    "MeshSpec",
    "PartitionRule",
    "ShardedParams",
    "Sharding",
    "all_gather",
    "all_reduce_mean",
    "all_reduce_sum",
    "all_to_all",
    "batch_sharding",
    "create_mesh",
    "leading_shard_count",
    "mesh_chip_count",
    "param_sharding_rules",
    "pipeline_apply",
    "replicated",
    "resolve_layout",
    "resolve_rules",
    "ring_attention",
    "ring_permute",
    "ring_sharding",
    "scatter_to_axis",
    "shard_params",
    "stack_stage_params",
    "state_resident_bytes",
    "state_shardings",
    "ulysses_attention",
    "validate_batch_sharding",
]
