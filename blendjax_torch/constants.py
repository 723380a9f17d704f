"""Shared constants (copied from ``blendjax/constants.py``)."""

# Consumer-side default receive timeout (ms); a timeout is a failure signal.
DEFAULT_TIMEOUTMS = 10_000

# Producer-side default timeout (ms).
DEFAULT_PRODUCER_TIMEOUTMS = 5_000

# Default high-water marks: small queues give natural backpressure
# between renderers and the training host.
DEFAULT_SEND_HWM = 10
DEFAULT_QUEUE_SIZE = 10

# First data port a launcher's address generator hands out.
DEFAULT_START_PORT = 11_000

# Wire-format magic for the zero-copy tensor codec.
WIRE_MAGIC = b"BJX1"

LOGGER_NAME = "blendjax_torch"
