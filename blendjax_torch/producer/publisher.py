"""Producer data publisher (copied from ``blendjax/producer/publisher.py``):
the reference's call shape ``DataPublisher(bind_addr, btid).publish(**kw)``
over :class:`~blendjax_torch.transport.DataPublisherSocket`, with the
zero-copy tensor codec and the lineage stamps on by default."""

from __future__ import annotations

from blendjax_torch import constants
from blendjax_torch.transport import DataPublisherSocket
from blendjax_torch.transport.wire import DEFAULT_COMPRESS_MIN_BYTES


class DataPublisher(DataPublisherSocket):
    def __init__(
        self,
        bind_addr: str,
        btid: int | None = None,
        send_hwm: int = constants.DEFAULT_SEND_HWM,
        lingerms: int = 0,
        codec: str = "tensor",
        copy: bool = False,
        compress_level: int = 0,
        compress_min_bytes: int = DEFAULT_COMPRESS_MIN_BYTES,
        compress_rle: bool = False,
        rle_cap: int | None = None,
        quantize_f16=(),
        lineage: bool = True,
        telemetry_every: int = 64,
        trace_every: int = 64,
        shm=None,
        shm_timeout_s: float = 5.0,
    ):
        super().__init__(
            bind_addr,
            btid=btid,
            send_hwm=send_hwm,
            codec=codec,
            lingerms=lingerms,
            copy=copy,
            compress_level=compress_level,
            compress_min_bytes=compress_min_bytes,
            compress_rle=compress_rle,
            rle_cap=rle_cap,
            quantize_f16=quantize_f16,
            lineage=lineage,
            telemetry_every=telemetry_every,
            trace_every=trace_every,
            shm=shm,
            shm_timeout_s=shm_timeout_s,
        )
