"""Host transport (numpy + zmq + msgpack only)."""

from blendjax_torch.transport.channels import (
    DataPublisherSocket,
    DataReceiverSocket,
    ReceiveTimeoutError,
    term_context,
    zmq_context,
)
from blendjax_torch.transport.wire import (
    TensorCodec,
    decode_message,
    encode_message,
)

__all__ = [
    "DataPublisherSocket",
    "DataReceiverSocket",
    "ReceiveTimeoutError",
    "TensorCodec",
    "decode_message",
    "encode_message",
    "term_context",
    "zmq_context",
]
