"""Consumer data path: stream, host ingest, device feeding."""

from blendjax_torch.data.batcher import (
    BatchAssembler,
    HostIngest,
    bucket_sizes,
    pad_to_bucket,
)
from blendjax_torch.data.echo import (
    EchoingPipeline,
    SampleReservoir,
    default_echo_augment,
)
from blendjax_torch.data.pipeline import (
    DeviceFeeder,
    StreamDataPipeline,
    TileStreamDecoder,
)
from blendjax_torch.data.schema import FieldSpec, SchemaError, StreamSchema
from blendjax_torch.data.shard_ingest import (
    ParallelBatchAssembler,
    ShardedHostIngest,
)
from blendjax_torch.data.stream import RemoteStream, partition_addresses
from blendjax_torch.data.torch_compat import RemoteIterableDataset

__all__ = [
    "BatchAssembler",
    "DeviceFeeder",
    "EchoingPipeline",
    "FieldSpec",
    "HostIngest",
    "ParallelBatchAssembler",
    "RemoteIterableDataset",
    "RemoteStream",
    "SampleReservoir",
    "SchemaError",
    "ShardedHostIngest",
    "StreamDataPipeline",
    "StreamSchema",
    "TileStreamDecoder",
    "bucket_sizes",
    "default_echo_augment",
    "pad_to_bucket",
    "partition_addresses",
]
