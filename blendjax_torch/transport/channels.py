"""The data-stream socket pair (copied from ``blendjax/transport/channels.py``).

PUSH (bind, small SNDHWM, IMMEDIATE) -> PULL (connect to all producers,
RCVHWM): backpressure through small queues, fair fan-in, at-most-once
delivery. A poll timeout raises :class:`ReceiveTimeoutError`.

Each published message carries ``_seq`` (a per-publisher counter) and
publish times, so the consumer can count sequence gaps exactly
(:class:`blendjax_torch.data.stream.RemoteStream`).
"""

from __future__ import annotations

import os
import threading
import time

import zmq

from blendjax_torch import constants
from blendjax_torch.transport.wire import decode_message, encode_message


class ReceiveTimeoutError(TimeoutError):
    """No message arrived within the timeout: treat the peer as failed."""


_context_lock = threading.Lock()
_context = None
_context_pid = None


def zmq_context() -> zmq.Context:
    """Process-wide ZMQ context (re-created after a fork)."""
    global _context, _context_pid
    with _context_lock:
        if _context is None or _context_pid != os.getpid():
            _context = zmq.Context()
            _context_pid = os.getpid()
        return _context


def term_context() -> None:
    """Terminate the process-wide context, blocking until closed sockets
    flushed their queues or their LINGER expired: call it at the end of a
    producer so a finite stream's tail is delivered."""
    global _context
    with _context_lock:
        ctx = _context
        _context = None
    if ctx is not None and _context_pid == os.getpid():
        ctx.term()


class DataPublisherSocket:
    """Producer end of the data stream: PUSH, bind side.

    ndarray payloads are handed to the socket by reference and sent after
    ``publish`` returns: a producer that reuses a buffer copies it first.
    """

    def __init__(self, bind_addr: str, btid: int | None = None,
                 send_hwm: int = constants.DEFAULT_SEND_HWM,
                 lingerms: int = 0):
        self.btid = btid
        self._seq = 0
        self.sock = zmq_context().socket(zmq.PUSH)
        self.sock.setsockopt(zmq.SNDHWM, send_hwm)
        self.sock.setsockopt(zmq.IMMEDIATE, 1)
        self.sock.setsockopt(zmq.LINGER, lingerms)
        self.sock.bind(bind_addr)
        # wildcard ports resolve at bind time
        self.addr = self.sock.getsockopt_string(zmq.LAST_ENDPOINT)

    def _stamp(self, data: dict) -> dict:
        data["_seq"] = self._seq
        data["_pub_wall"] = time.time()
        data["_pub_mono"] = time.monotonic()
        self._seq += 1
        return data

    def publish(self, **kwargs) -> None:
        """Publish one message dict, stamped with ``btid`` and ``_seq``."""
        data = self._stamp({"btid": self.btid, **kwargs})
        self.sock.send_multipart(encode_message(data), copy=False)

    def close(self) -> None:
        self.sock.close()


class DataReceiverSocket:
    """Consumer end: PULL, connected to every producer address.

    ``recv`` returns the decoded message dict or raises
    :class:`ReceiveTimeoutError`."""

    def __init__(self, addresses, queue_size: int = constants.DEFAULT_QUEUE_SIZE,
                 timeoutms: int = constants.DEFAULT_TIMEOUTMS,
                 defer_rle: bool = False):
        if isinstance(addresses, str):
            addresses = [addresses]
        self.addresses = list(addresses)
        self.timeoutms = timeoutms
        self.defer_rle = bool(defer_rle)
        self.sock = zmq_context().socket(zmq.PULL)
        self.sock.setsockopt(zmq.RCVHWM, queue_size)
        self.sock.setsockopt(zmq.LINGER, 0)
        for addr in self.addresses:
            self.sock.connect(addr)
        self.poller = zmq.Poller()
        self.poller.register(self.sock, zmq.POLLIN)

    def recv(self, timeoutms: int | None = None):
        t = self.timeoutms if timeoutms is None else timeoutms
        if self.sock not in dict(self.poller.poll(t)):
            raise ReceiveTimeoutError(
                f"no message within {t} ms from {self.addresses}"
            )
        frames = self.sock.recv_multipart(copy=False)
        return decode_message(
            [f.buffer for f in frames], defer_rle=self.defer_rle,
        )

    def close(self) -> None:
        self.sock.close()
