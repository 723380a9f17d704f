"""ScenarioService: publish the scenario space to every producer (copied
from ``blendjax/scenario/service.py``).

One PAIR duplex channel per producer carries a two-verb, versioned
protocol:

- consumer -> producer: ``{"scenario_space": <wire form>,
  "scenario_version": v}``, the whole space, sent again on every
  curriculum update and on every membership change (a newcomer holds the
  current version before its first frame is counted);
- producer -> consumer: ``{"scenario_ack": v}``; the service keeps each
  member's highest acked version, so :meth:`ScenarioService.wait_acked`
  can hold a run until the fleet has converged.

Every zmq socket lives on one private service thread: ``attach``,
``detach`` and ``publish`` queue commands from any thread (the fleet
controller's, the train loop's) and the service thread applies them. The
channels refuse pickles (``allow_pickle=False``), and every send has a
500 ms timeout, so a dead member costs one bounded send, never the
thread. The fleet controller (:class:`~blendjax_torch.fleet.FleetController`)
calls :meth:`attach` before it admits a newcomer's data address and
:meth:`detach` when an instance retires.
"""

from __future__ import annotations

import queue
import threading
import time

from blendjax_torch.scenario.accounting import accounting
from blendjax_torch.scenario.space import ScenarioSpace
from blendjax_torch.utils.logging import get_logger
from blendjax_torch.utils.metrics import metrics
from blendjax_torch.utils.tg import guard

logger = get_logger("scenario")

_TICK_S = 0.02


class ScenarioService:
    """Versioned scenario-space distribution over per-producer duplex
    channels.

    ``space`` is the initial :class:`~blendjax_torch.scenario.space.ScenarioSpace`
    (optional: it can arrive later through :meth:`publish`). ``ledger`` is the accounting instance new spaces
    are declared into (defaults to the process-wide one).
    """

    def __init__(self, space: ScenarioSpace | None = None,
                 ledger=accounting, ack_timeout_s: float = 10.0):
        self.ledger = ledger
        self.ack_timeout_s = float(ack_timeout_s)
        self._lock = threading.Lock()
        self._space_wire: dict | None = None
        self._version = 0
        self.space: ScenarioSpace | None = None
        # membership/ack bookkeeping only under `_lock` (checked by the
        # sanitizer under BLENDJAX_THREADGUARD=1, blendjax_torch.utils.tg)
        self._members: dict = guard(  # btid -> addr (bookkeeping view)
            {}, name="scenario.members", lock=self._lock
        )
        self._acked: dict = guard(  # btid -> highest acked version
            {}, name="scenario.acked", lock=self._lock
        )
        self._cmds: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if space is not None:
            self.publish(space)

    # -- public API (any thread) ----------------------------------------------

    def attach(self, btid, ctrl_addr: str) -> None:
        """Admit one producer's duplex endpoint; the service thread
        connects and immediately sends the current space (if any), so
        membership changes re-publish by construction."""
        with self._lock:
            self._members[btid] = ctrl_addr
        self._ensure_thread()
        self._cmds.put(("attach", btid, ctrl_addr))

    def detach(self, btid) -> None:
        """Retire one producer's duplex endpoint (closed on the owning
        thread; unknown btids are a no-op)."""
        with self._lock:
            self._members.pop(btid, None)
            self._acked.pop(btid, None)
        if self._thread is not None:
            self._cmds.put(("detach", btid))

    def publish(self, space: ScenarioSpace) -> int:
        """Publish ``space`` (at its CURRENT version) to every member;
        returns the version sent. Snapshot semantics: the wire form is
        taken here, so later in-place curriculum mutations don't race
        the send."""
        wire = space.to_wire()
        with self._lock:
            self.space = space
            self._space_wire = wire
            self._version = space.version
        self.ledger.declare(space)
        metrics.gauge("scenario.space_version", space.version)
        self._ensure_thread()
        self._cmds.put(("publish", wire, space.version))
        return space.version

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def acked_versions(self) -> dict:
        with self._lock:
            return dict(self._acked)

    def members(self) -> dict:
        with self._lock:
            return dict(self._members)

    def wait_acked(self, version: int | None = None, btids=None,
                   timeout: float | None = None) -> bool:
        """Block until every member in ``btids`` (default: all current
        members) acked ``version`` (default: the latest published).
        Returns False on timeout — a producer that never acks is a
        liveness signal, not an exception."""
        deadline = time.monotonic() + (
            self.ack_timeout_s if timeout is None else timeout
        )
        while True:
            with self._lock:
                v = self._version if version is None else int(version)
                targets = (
                    list(self._members) if btids is None else list(btids)
                )
                ok = all(self._acked.get(b, -1) >= v for b in targets)
            if ok:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def state(self) -> dict:
        """Reporter-friendly snapshot (rides the StatsReporter archive
        beside the fleet state)."""
        with self._lock:
            return {
                "version": self._version,
                "members": {str(k): v for k, v in self._members.items()},
                "acked": {str(k): v for k, v in self._acked.items()},
            }

    # -- service thread --------------------------------------------------------

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._serve, name="blendjax-torch-scenario-service",
                daemon=True,
            )
            self._thread.start()

    def _serve(self) -> None:
        # btid -> PairChannel; created, used, and closed ONLY here.
        import zmq

        from blendjax_torch.transport import PairChannel

        channels: dict = {}

        def send_space(btid, chan, wire, version) -> None:
            try:
                chan.send(scenario_space=wire, scenario_version=version)
                metrics.count("scenario.publishes")
            except Exception:
                # incl. zmq.Again from the send timeout below: a dead/
                # wedged member must cost one bounded send, never the
                # whole fleet's distribution thread
                logger.exception(
                    "scenario publish to %r failed (kept attached; the "
                    "next publish retries)", btid,
                )

        try:
            while not self._stop.is_set():
                try:
                    cmd = self._cmds.get(timeout=_TICK_S)
                except queue.Empty:
                    cmd = None
                if cmd is not None:
                    op = cmd[0]
                    if op == "attach":
                        _, btid, addr = cmd
                        old = channels.pop(btid, None)
                        if old is not None:
                            old.close()
                        try:
                            # creator affinity: the duplex socket is
                            # born, used, and closed ONLY on this
                            # service thread
                            chan = guard(
                                PairChannel(
                                    addr, bind=False, allow_pickle=False,
                                    default_timeoutms=0,
                                ),
                                name=f"scenario.chan[{btid}]",
                                affinity="creator",
                            )
                            # bounded sends: a PAIR socket whose peer
                            # died (no 'leave') or whose pipe filled
                            # BLOCKS on send by default — one such
                            # member would wedge this thread for every
                            # producer. With a send timeout the send
                            # raises Again and send_space logs+skips.
                            chan.sock.setsockopt(zmq.SNDTIMEO, 500)
                        except Exception:
                            logger.exception(
                                "scenario attach to %r at %r failed",
                                btid, addr,
                            )
                            with self._lock:
                                self._members.pop(btid, None)
                            continue
                        channels[btid] = chan
                        with self._lock:
                            wire, version = self._space_wire, self._version
                        if wire is not None:
                            # membership change == re-publish: the
                            # newcomer holds the current space before
                            # its data address is even admitted
                            send_space(btid, chan, wire, version)
                    elif op == "detach":
                        chan = channels.pop(cmd[1], None)
                        if chan is not None:
                            chan.close()
                    elif op == "publish":
                        _, wire, version = cmd
                        for btid, chan in channels.items():
                            send_space(btid, chan, wire, version)
                # drain acks from every channel (non-blocking). The
                # WHOLE per-message handling sits in the try: a remote
                # member controls its own ctrl endpoint, and one
                # malformed ack ({"scenario_ack": "junk"}, a non-dict
                # payload) must be refused, not kill the fleet's only
                # distribution thread.
                for btid, chan in channels.items():
                    while True:
                        try:
                            msg = chan.recv(timeoutms=0)
                        except Exception:
                            # recv-level failure (incl. a refused
                            # pickle frame): break, not continue — a
                            # persistent socket error would otherwise
                            # spin this loop forever; the next 20 ms
                            # tick retries the drain
                            logger.exception(
                                "scenario ack recv from %r failed", btid
                            )
                            break
                        if msg is None:
                            break
                        try:
                            ver = msg.get("scenario_ack")
                            if ver is None:
                                continue
                            ver = int(ver)
                        except Exception:
                            logger.exception(
                                "malformed scenario ack from %r", btid
                            )
                            continue
                        metrics.count("scenario.acks")
                        with self._lock:
                            if ver > self._acked.get(btid, -1):
                                self._acked[btid] = ver
                with self._lock:
                    metrics.gauge("scenario.members", len(self._members))
        finally:
            for chan in channels.values():
                chan.close()

    # -- lifecycle -------------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "ScenarioService":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["ScenarioService"]
