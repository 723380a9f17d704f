"""Host transport (numpy + zmq + msgpack only)."""

from blendjax_torch.transport.channels import (
    DataPublisherSocket,
    DataReceiverSocket,
    ReceiveTimeoutError,
    term_context,
    zmq_context,
)
from blendjax_torch.transport.shm import (
    REGISTRY_ENV,
    ShmCapacityError,
    ShmRing,
    attach_ring,
    detach_all,
    reap_registry,
    resolve_message,
    unlink_segment,
)
from blendjax_torch.transport.wire import (
    CODECS,
    PickleCodec,
    TensorCodec,
    WireCompressState,
    WireCounts,
    decode_message,
    encode_message,
    sizeof_frames,
)

__all__ = [
    "CODECS",
    "DataPublisherSocket",
    "DataReceiverSocket",
    "PickleCodec",
    "REGISTRY_ENV",
    "ReceiveTimeoutError",
    "ShmCapacityError",
    "ShmRing",
    "TensorCodec",
    "WireCompressState",
    "WireCounts",
    "attach_ring",
    "decode_message",
    "detach_all",
    "encode_message",
    "reap_registry",
    "resolve_message",
    "sizeof_frames",
    "term_context",
    "unlink_segment",
    "zmq_context",
]
