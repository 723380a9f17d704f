"""Remote producer admission: announce over TCP, join the ingest set
(copied from ``blendjax/fleet/admission.py``).

A launcher scales only producers it spawns on its own machine. A producer
that already runs elsewhere announces itself instead, and the consumer
admits it. One REP socket beside the data channel speaks two verbs:

- ``{"op": "announce", "btid": ..., "data_addr": ..., "telemetry": {}}``:
  the consumer connects ``data_addr`` into its ingest (``pipeline.connect``,
  applied by the ingest thread), registers the btid with the frame
  lineage and replies ``{"ok": true}``;
- ``{"op": "leave", "btid": ...}``: a scheduled departure; the address
  stays connected through the controller's drain grace window, then
  disconnects and retires from the lineage.

The producer side is :func:`announce` and :func:`leave` over
:class:`~blendjax_torch.transport.channels.RpcClient`;
``blendjax_torch/fleet/synthetic.py --announce ADDR`` shows the whole
flow. The endpoint faces the network, so both ends refuse pickles
(``allow_pickle=False``), and a request the server refuses gets an
error reply while the server keeps serving (the JAX package's serving
thread ends on such a request).
"""

from __future__ import annotations

import threading

from blendjax_torch.utils.logging import get_logger
from blendjax_torch.utils.metrics import metrics

logger = get_logger("fleet")

_POLL_MS = 250


class AdmissionServer:
    """Registration endpoint for remote producers (REP, bind).

    ``on_announce(btid, data_addr, telemetry) -> dict`` and
    ``on_leave(btid) -> dict`` are the policy hooks: a
    :class:`~blendjax_torch.fleet.controller.FleetController` wires its
    ``admit_remote``/``retire_remote``; tests wire plain recorders.
    The zmq socket is created on the serving thread, so :meth:`start`
    blocks briefly until the bound address is known; read it from
    :attr:`addr` (wildcard ports resolve at bind).
    """

    def __init__(
        self,
        bind_addr: str = "tcp://127.0.0.1:0",
        on_announce=None,
        on_leave=None,
    ):
        self.bind_addr = bind_addr
        self.on_announce = on_announce
        self.on_leave = on_leave
        self.addr: str | None = None
        self._ready = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._startup_error: BaseException | None = None

    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "announce":
            btid = req.get("btid")
            data_addr = req.get("data_addr")
            if btid is None or not data_addr:
                return {"ok": False, "error": "announce needs btid + data_addr"}
            metrics.count("fleet.announce_requests")
            if self.on_announce is None:
                return {"ok": False, "error": "no admission policy attached"}
            return self.on_announce(
                btid, str(data_addr), req.get("telemetry") or {}
            )
        if op == "leave":
            if self.on_leave is None:
                return {"ok": False, "error": "no admission policy attached"}
            return self.on_leave(req.get("btid"))
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _serve(self) -> None:
        from blendjax_torch.transport.channels import RpcServer

        try:
            server = RpcServer(self.bind_addr, allow_pickle=False)
        except BaseException as e:  # bad bind addr: surface in start()
            # published through the _ready Event: written before set(),
            # read in start() only after wait()
            self._startup_error = e
            self._ready.set()
            raise
        self.addr = server.addr
        self._ready.set()
        try:
            while not self._stop.is_set():
                try:
                    req = server.recv(timeoutms=_POLL_MS)
                except Exception as e:
                    # a request the codec refuses (a pickle, a malformed
                    # frame) was received all the same: answer it, and
                    # keep serving (REP must reply before the next recv)
                    logger.warning("admission request refused: %r", e)
                    server.reply(ok=False, error=f"refused: {e!r}"[:200])
                    continue
                if req is None:
                    continue
                try:
                    reply = self._handle(req)
                except Exception as e:  # policy error: reply, keep serving
                    logger.exception("admission handler failed")
                    reply = {"ok": False, "error": repr(e)[:200]}
                server.reply(**reply)
        finally:
            server.close()

    def start(self, timeout: float = 5.0) -> "AdmissionServer":
        if self._thread is not None:
            raise RuntimeError("the admission server is already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._serve, name="blendjax-torch-fleet-admission", daemon=True
        )
        self._thread.start()
        if not self._ready.wait(timeout):
            raise RuntimeError("admission server did not bind in time")
        if self._startup_error is not None:
            raise self._startup_error
        logger.info("fleet admission endpoint: %s", self.addr)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "AdmissionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def announce(server_addr: str, btid, data_addr: str,
             telemetry: dict | None = None,
             timeoutms: int = 5000) -> dict:
    """Producer-side: register ``data_addr`` with a consumer's
    admission endpoint; returns the reply dict (``{"ok": True}`` on
    admission). Raises :class:`~blendjax_torch.transport.ReceiveTimeoutError`
    when the endpoint is unreachable — callers should retry with
    backoff (the consumer may still be starting)."""
    from blendjax_torch.transport.channels import RpcClient

    client = RpcClient(server_addr, timeoutms=timeoutms, allow_pickle=False)
    try:
        return client.call(
            op="announce", btid=btid, data_addr=data_addr,
            telemetry=telemetry or {},
        )
    finally:
        client.close()


def leave(server_addr: str, btid, timeoutms: int = 5000) -> dict:
    """Producer-side graceful departure: ask the consumer to retire
    this btid after its drain grace window. Publish the tail and
    ``term_context()`` BEFORE exiting — the window exists so that
    flush lands."""
    from blendjax_torch.transport.channels import RpcClient

    client = RpcClient(server_addr, timeoutms=timeoutms, allow_pickle=False)
    try:
        return client.call(op="leave", btid=btid)
    finally:
        client.close()
