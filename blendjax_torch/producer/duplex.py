"""Producer end of the duplex control channel (copied from
``blendjax/producer/duplex.py``): a :class:`~blendjax_torch.transport.PairChannel`
that binds, with the producer's shorter default timeout. Like every
receiver of the port it refuses pickles unless ``allow_pickle=True``."""

from __future__ import annotations

from blendjax_torch import constants
from blendjax_torch.transport import PairChannel


class DuplexChannel(PairChannel):
    def __init__(
        self,
        addr: str,
        btid: int | None = None,
        lingerms: int = 0,
        hwm: int = constants.DEFAULT_SEND_HWM,
        codec: str = "tensor",
        allow_pickle: bool = False,
    ):
        super().__init__(
            addr,
            btid=btid,
            bind=True,
            hwm=hwm,
            lingerms=lingerms,
            codec=codec,
            default_timeoutms=constants.DEFAULT_PRODUCER_TIMEOUTMS,
            allow_pickle=allow_pickle,
        )
