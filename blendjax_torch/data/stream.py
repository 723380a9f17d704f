"""Live message stream from a fleet of producers (copied from
``blendjax/data/stream.py``, without recording, decode-ahead pools and
elastic membership).

Every publisher numbers its messages (``_seq``); the stream pops those
stamps and counts, per producer, the messages that never arrived
(``seq_gaps``) and restarts (a sequence that goes backwards), so a run can
assert that its fleet delivered everything.
"""

from __future__ import annotations

import time

from blendjax_torch import constants
from blendjax_torch.transport import DataReceiverSocket, ReceiveTimeoutError


class RemoteStream:
    """Iterable over decoded messages from all ``addresses``.

    A receive that waits ``timeoutms`` raises ``ReceiveTimeoutError``;
    ``defer_rle`` leaves run-length frames of prebatched messages packed
    for the device-side expansion.
    """

    def __init__(self, addresses, queue_size: int = constants.DEFAULT_QUEUE_SIZE,
                 timeoutms: int = constants.DEFAULT_TIMEOUTMS,
                 defer_rle: bool = False):
        if isinstance(addresses, str):
            addresses = [addresses]
        self.addresses = list(addresses)
        self.queue_size = queue_size
        self.timeoutms = timeoutms
        self.defer_rle = bool(defer_rle)
        self.seq_gaps = 0
        self.restarts = 0
        self.messages = 0
        self._last_seq: dict = {}
        self._stop_requested = False

    def request_stop(self) -> None:
        """Ask a blocked iteration to exit at its next poll slice (<=250 ms)."""
        self._stop_requested = True

    def clear_stop_request(self) -> None:
        self._stop_requested = False

    def _account(self, msg: dict) -> dict:
        """Pop the publish stamps and update the per-producer gap count."""
        seq = msg.pop("_seq", None)
        msg.pop("_pub_wall", None)
        msg.pop("_pub_mono", None)
        self.messages += 1
        if seq is not None:
            key = msg.get("btid")
            last = self._last_seq.get(key)
            if last is not None:
                if seq > last + 1:
                    self.seq_gaps += seq - last - 1
                elif seq <= last:
                    self.restarts += 1
            self._last_seq[key] = seq
        return msg

    def _recv_sliced(self, recv):
        """One receive with ``timeoutms`` semantics, polled in <=250 ms
        slices so :meth:`request_stop` is honoured; None when stopped."""
        deadline = time.monotonic() + self.timeoutms / 1e3
        while True:
            if self._stop_requested:
                return None
            remaining_ms = (deadline - time.monotonic()) * 1e3
            try:
                return recv.recv(timeoutms=max(0, min(250, int(remaining_ms))))
            except ReceiveTimeoutError:
                if remaining_ms <= 0:
                    raise ReceiveTimeoutError(
                        f"no message within {self.timeoutms} ms from "
                        f"{self.addresses}"
                    ) from None

    def __iter__(self):
        recv = DataReceiverSocket(
            self.addresses, queue_size=self.queue_size,
            timeoutms=self.timeoutms, defer_rle=self.defer_rle,
        )
        try:
            while True:
                msg = self._recv_sliced(recv)
                if msg is None:
                    return
                yield self._account(msg)
        finally:
            recv.close()
