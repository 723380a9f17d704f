"""FleetController: verdict-driven autoscaling over an elastic launcher
(copied from ``blendjax/fleet/controller.py``).

The stall doctor names the bound each tick (:mod:`blendjax_torch.obs.doctor`;
the RL doctor's vocabulary through :meth:`FleetPolicy.rl`), and this module
acts on it:

- **scale up** on a sustained ``producer-bound`` or ``echo-saturated``
  verdict: :meth:`ProcessLauncher.add_instance` launches a producer (the
  next btid and seed) and the consumer admits its address while it runs
  (``pipeline.connect(addr)``, applied by the ingest thread);
- **scale down** on a sustained ``step-bound`` or ``idle`` verdict: the
  highest launcher instance retires with drain (SIGTERM, a flush, exit);
  the consumer keeps receiving through a grace window, then disconnects
  the address and retires the btid from the lineage;
- **respawn** a crashed (not retired) instance in place, same argv and
  btid; the lineage reads its fresh numbering as a restart;
- **remote admission**: with an
  :class:`~blendjax_torch.fleet.admission.AdmissionServer`, producers on
  other machines announce themselves and join the ingest set.

A verdict must hold ``up_after`` / ``down_after`` consecutive ticks before
it counts, and after a scale event the controller holds for
``cooldown_s``. Each decision runs under a ``fleet.decision`` span;
``fleet.instances``, ``fleet.scale_ups``, ``fleet.scale_downs``,
``fleet.respawns`` and ``fleet.admissions`` go to the registry, and a
bounded event log rides :meth:`FleetController.state`.

``tick()`` takes plain verdicts (objects with a ``kind``, dicts or
strings) and duck-typed launcher and connector handles, so tests drive
every arm without sockets, processes or a clock. Checks the JAX package
makes with ``assert`` (the policy's bounds, a second ``start``) raise
``ValueError`` or ``RuntimeError`` here.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

from blendjax_torch.utils.logging import get_logger
from blendjax_torch.utils.metrics import metrics

logger = get_logger("fleet")


@dataclasses.dataclass(frozen=True)
class FleetPolicy:
    """Scaling policy knobs (docs/fleet.md has the tuning table).

    ``min_instances``/``max_instances`` bound the LAUNCHER-owned fleet;
    remote (admitted) members ride outside the bounds — the controller
    never retires what it didn't launch. ``up_after``/``down_after``
    are hysteresis in ticks; ``cooldown_s`` the post-event hold;
    ``step`` how many instances one scale-up adds; ``drain_grace_s``
    how long the consumer keeps receiving from a retired producer
    before its address is disconnected (the flushed tail's window).
    """

    min_instances: int = 1
    max_instances: int = 4
    up_after: int = 2
    down_after: int = 4
    cooldown_s: float = 10.0
    step: int = 1
    drain_grace_s: float = 2.0
    scale_up_verdicts: tuple = ("producer-bound", "echo-saturated")
    scale_down_verdicts: tuple = ("step-bound", "idle")

    def __post_init__(self):
        if not 1 <= self.min_instances <= self.max_instances:
            raise ValueError(
                f"need 1 <= min_instances <= max_instances, got "
                f"{self.min_instances} and {self.max_instances}")
        if self.up_after < 1 or self.down_after < 1:
            raise ValueError(
                f"up_after and down_after must be >= 1, got "
                f"{self.up_after} and {self.down_after}")

    @classmethod
    def rl(cls, **overrides) -> "FleetPolicy":
        """The actor-learner verdict vocabulary
        (:func:`blendjax_torch.rl.diagnose_rl`): scale env
        producers UP when the learner starves for transitions
        (``env-bound`` — reservoir fill rate can't cover the sample
        rate) and DOWN when actors outrun the learner so far that
        fresh transitions die undrawn (``learner-bound``). Pair with
        ``FleetController(diagnose=blendjax_torch.rl.diagnose_rl_current,
        policy=FleetPolicy.rl())`` — the controller machinery
        (hysteresis, cooldown, drain grace, remote admission) is
        verdict-vocabulary-agnostic and carries over unchanged."""
        kwargs = {
            "scale_up_verdicts": ("env-bound",),
            "scale_down_verdicts": ("learner-bound",),
            **overrides,
        }
        return cls(**kwargs)


def _valid_endpoint(addr) -> bool:
    """Cheap sanity gate for network-supplied endpoints: enough to keep
    a junk address from being queued onto the ingest thread, where a
    zmq ``connect`` raise would surface far from the request. tcp
    endpoints need a ``host:port`` tail (zmq raises EINVAL on a missing
    port); path-style protos (ipc/inproc) just need a body."""
    proto, sep, rest = str(addr).partition("://")
    if not (proto and sep and rest):
        return False
    if proto == "tcp":
        host, sep2, port = rest.rpartition(":")
        return bool(sep2 and host) and port.isdigit()
    return True


def _verdict_kind(verdict) -> str | None:
    """Accept a Verdict, a plain ``{"kind": ...}`` dict, or a bare
    string — fixtures feed whichever is cheapest."""
    if verdict is None:
        return None
    kind = getattr(verdict, "kind", None)
    if kind is not None:
        return kind
    if isinstance(verdict, dict):
        return verdict.get("kind")
    return str(verdict)


class FleetController:
    """One control loop: diagnose → decide → scale/respawn.

    ``launcher`` must speak the elastic-membership surface of
    :class:`blendjax_torch.launcher.ProcessLauncher` (``active_indices``,
    ``add_instance``, ``retire_instance``, ``respawn_instance``,
    ``poll_processes``, ``instance_sockets``). ``connector`` is the
    consumer side — anything with ``connect(addr)`` / ``disconnect
    (addr)`` (a :class:`~blendjax_torch.data.pipeline.StreamDataPipeline`,
    a :class:`~blendjax_torch.data.stream.RemoteStream`, or a test stub).
    ``diagnose`` overrides the verdict source (default: the process-
    wide :func:`blendjax_torch.obs.diagnose_current`); ``health`` an optional
    zero-arg healthy-bool (e.g. ``lambda: reporter.healthy`` — the
    SloWatchdog state): while unhealthy the controller never scales
    DOWN, and breach-window respawns are tagged in the event log.
    ``instance_args`` are the argv tail for scaled-up producers;
    ``None`` inherits the running fleet's args at the launcher (a new
    instance must match its peers' shape/encoding config).

    ``scenario_service`` (a :class:`blendjax_torch.scenario.ScenarioService`)
    keeps scenario distribution consistent under elastic membership:
    a scaled-up instance's ``ctrl_socket_name`` duplex address is
    attached — and the CURRENT space published to it — BEFORE its data
    address joins the ingest fan-in, so the newcomer's first counted
    frame already carries the current space version (producers hold
    publishing for the first space — see
    ``blendjax_torch.fleet.synthetic --scenario-wait``); a retiring
    instance's duplex channel closes cleanly at retire time; remote
    producers announcing a ``ctrl_addr`` in their telemetry join the
    scenario fleet the same way.

    Drive it yourself (``tick()`` per loop, as ``chip_smoke.py`` does) or
    let ``start()`` run a daemon control thread every ``interval_s``:
    the home for the blocking subprocess lifecycle this class performs,
    away from the ingest and draw loops.
    """

    def __init__(
        self,
        launcher,
        connector=None,
        policy: FleetPolicy | None = None,
        socket_name: str = "DATA",
        interval_s: float = 5.0,
        diagnose=None,
        health=None,
        respawn_dead: bool = True,
        instance_args=None,
        lineage=None,
        registry=metrics,
        event_log: int = 64,
        scenario_service=None,
        ctrl_socket_name: str = "CTRL",
    ):
        self.launcher = launcher
        self.connector = connector
        self.policy = policy or FleetPolicy()
        self.socket_name = socket_name
        self.scenario_service = scenario_service
        self.ctrl_socket_name = ctrl_socket_name
        self.interval_s = float(interval_s)
        self.diagnose = diagnose
        self.health = health
        self.respawn_dead = bool(respawn_dead)
        self.instance_args = instance_args
        if lineage is None:
            from blendjax_torch.obs.lineage import lineage as default_lineage

            lineage = default_lineage
        self.lineage = lineage
        self.registry = registry
        self.events: collections.deque = collections.deque(
            maxlen=max(1, int(event_log))
        )
        self.remote: dict = {}  # btid -> data_addr (admitted, not launched)
        self.last_verdict_kind: str | None = None
        self._up_streak = 0
        self._down_streak = 0
        self._last_scale_t: float | None = None
        self._pending_disconnects: list = []  # (due_t, addr, btid)
        self._ticks = 0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- event/metric plumbing ----------------------------------------------

    def _event(self, action: str, **detail) -> dict:
        ev = {"t": time.time(), "action": action, **detail}
        self.events.append(ev)
        logger.info("fleet %s: %s", action, detail)
        return ev

    def _gauge_instances(self) -> int:
        n = self.launcher.active_count() + len(self.remote)
        self.registry.gauge("fleet.instances", n)
        return n

    # -- remote admission ----------------------------------------------------

    def admit_remote(self, btid, data_addr: str, telemetry=None,
                     now: float | None = None) -> dict:
        """Admit an announced remote producer into the ingest set (the
        :class:`~blendjax_torch.fleet.admission.AdmissionServer` callback;
        also callable directly). Idempotent per (btid, addr); a
        re-announce with a NEW addr (producer restarted and rebound a
        wildcard port) retires the stale endpoint through the drain
        grace window instead of leaking it."""
        with self._lock:
            prev = self.remote.get(btid)
            if prev == data_addr:
                # Re-announce of the SAME endpoint is a retry (e.g. a
                # deferred connect failed and rolled back its stream
                # bookkeeping): send the connect again — it's idempotent
                # all the way down (a live duplicate is skipped at the
                # channel's address bookkeeping).
                if self.connector is not None:
                    self.connector.connect(data_addr)
                return {"ok": True, "already": True}
            if self.connector is None:
                return {"ok": False, "error": "no connector attached"}
            if not _valid_endpoint(data_addr):
                # This endpoint faces the network: reject junk HERE,
                # with a reply, not later as an uncaught error on the
                # ingest thread that owns the socket.
                return {
                    "ok": False,
                    "error": f"malformed data_addr {str(data_addr)!r}",
                }
            if prev is not None:
                # btid=None: addr-only retirement — the member itself
                # never left, so its lineage state stays registered
                now_ = time.monotonic() if now is None else now
                self._pending_disconnects.append(
                    (now_ + self.policy.drain_grace_s, prev, None)
                )
            ctrl_addr = (telemetry or {}).get("ctrl_addr")
            if (
                self.scenario_service is not None
                and ctrl_addr and _valid_endpoint(ctrl_addr)
            ):
                # scenario before data, like _scale_up: the announced
                # duplex endpoint receives the current space first
                self.scenario_service.attach(btid, str(ctrl_addr))
            self.connector.connect(data_addr)
            self.remote[btid] = data_addr
            self.lineage.register(btid)
            self.registry.count("fleet.admissions")
            self._event(
                "admit", btid=btid, addr=data_addr,
                telemetry=telemetry or {},
            )
            self._gauge_instances()
            return {"ok": True}

    def retire_remote(self, btid, now: float | None = None) -> dict:
        """Schedule a remote member's departure: the address stays
        connected through the drain grace window (its final flush is
        in flight), then disconnects and retires from lineage."""
        with self._lock:
            addr = self.remote.pop(btid, None)
            if addr is None:
                return {"ok": False, "error": f"unknown btid {btid!r}"}
            if self.scenario_service is not None:
                self.scenario_service.detach(btid)
            now = time.monotonic() if now is None else now
            self._pending_disconnects.append(
                (now + self.policy.drain_grace_s, addr, btid)
            )
            self._event("leave", btid=btid, addr=addr)
            self._gauge_instances()
            return {"ok": True}

    # -- the control loop ----------------------------------------------------

    def tick(self, verdict=None, now: float | None = None) -> dict:
        """One decision cycle; returns ``{"verdict", "action", ...}``.

        ``verdict`` may be anything with a ``kind`` (or a plain dict /
        string) — when omitted the process-wide doctor runs. ``now``
        (monotonic seconds) exists so hysteresis/cooldown fixtures are
        clockless."""
        now = time.monotonic() if now is None else now
        with self._lock, self.registry.span("fleet.decision"):
            self._ticks += 1
            decision = self._tick_locked(verdict, now)
        return decision

    def _tick_locked(self, verdict, now: float) -> dict:
        p = self.policy
        # 1. liveness: respawn crashed (non-retired) launcher instances
        #    in place — btid and argv survive, lineage reads the fresh
        #    numbering as a restart.
        respawned = []
        if self.respawn_dead:
            codes = self.launcher.poll_processes()
            for i in self.launcher.active_indices():
                if codes[i] is not None:
                    self.launcher.respawn_instance(i)
                    self.registry.count("fleet.respawns")
                    healthy = self._healthy()
                    self._event(
                        "respawn", instance=i, exit_code=codes[i],
                        during_breach=not healthy,
                    )
                    respawned.append(i)

        # 2. flush drain-grace disconnects that came due
        still_pending = []
        for due, addr, btid in self._pending_disconnects:
            if now >= due:
                if self.connector is not None:
                    self.connector.disconnect(addr)
                if btid is not None:  # None = addr-only (re-announce)
                    self.lineage.retire(btid)
                self._event("disconnect", btid=btid, addr=addr)
            else:
                still_pending.append((due, addr, btid))
        self._pending_disconnects = still_pending

        # 3. verdict → streaks
        if verdict is None and self.diagnose is not None:
            verdict = self.diagnose()
        elif verdict is None:
            from blendjax_torch.obs import diagnose_current

            verdict = diagnose_current()
        kind = _verdict_kind(verdict)
        self.last_verdict_kind = kind
        if kind in p.scale_up_verdicts:
            self._up_streak += 1
            self._down_streak = 0
        elif kind in p.scale_down_verdicts:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0

        # 4. scale decision (hysteresis + cooldown + bounds)
        active = self.launcher.active_count()
        in_cooldown = (
            self._last_scale_t is not None
            and now - self._last_scale_t < p.cooldown_s
        )
        action = "hold"
        detail: dict = {}
        healthy = self._healthy()
        if (
            self._up_streak >= p.up_after
            and not in_cooldown
            and active < p.max_instances
        ):
            target = min(active + p.step, p.max_instances)
            added = self._scale_up(target - active, kind)
            action, detail = "scale_up", {"added": added}
        elif (
            self._down_streak >= p.down_after
            and not in_cooldown
            and active > p.min_instances
            and healthy  # never shrink a breaching fleet
        ):
            removed = self._scale_down(now, kind)
            action, detail = "scale_down", {"removed": removed}
        if action != "hold":
            self._last_scale_t = now
            self._up_streak = self._down_streak = 0

        n = self._gauge_instances()
        return {
            "verdict": kind,
            "action": action,
            "instances": n,
            "respawned": respawned,
            "healthy": healthy,
            "up_streak": self._up_streak,
            "down_streak": self._down_streak,
            **detail,
        }

    def _healthy(self) -> bool:
        if self.health is None:
            return True
        try:
            return bool(self.health())
        except Exception:
            logger.exception("fleet health probe failed; assuming healthy")
            return True

    def _scale_up(self, count: int, kind) -> list:
        added = []
        for _ in range(count):
            i, sockets = self.launcher.add_instance(
                extra_args=self.instance_args
            )
            addr = sockets[self.socket_name]
            self.lineage.register(i)
            ctrl_addr = sockets.get(self.ctrl_socket_name)
            if self.scenario_service is not None and ctrl_addr:
                # scenario BEFORE data: attach publishes the current
                # space to the newcomer's duplex channel, and the
                # producer holds its first frame for it — so by the
                # time ingest counts a frame, it is version-stamped
                self.scenario_service.attach(i, ctrl_addr)
            if self.connector is not None:
                self.connector.connect(addr)
            self.registry.count("fleet.scale_ups")
            self._event("scale_up", instance=i, addr=addr, verdict=kind)
            added.append((i, addr))
        return added

    def _scale_down(self, now: float, kind) -> list:
        victim = self.launcher.active_indices()[-1]
        sockets = self.launcher.retire_instance(victim, drain=True)
        addr = sockets[self.socket_name]
        if self.scenario_service is not None and sockets.get(
            self.ctrl_socket_name
        ):
            # the duplex channel closes NOW (cleanly, on the service's
            # owning thread): the producer is gone; only its already-
            # published data tail rides out the drain grace window
            self.scenario_service.detach(victim)
        # drain-then-disconnect: the producer's TERM flush is delivered
        # through the still-connected pipe; the disconnect lands a
        # grace window later (step 2 of a future tick).
        self._pending_disconnects.append(
            (now + self.policy.drain_grace_s, addr, victim)
        )
        self.registry.count("fleet.scale_downs")
        self._event("scale_down", instance=victim, addr=addr, verdict=kind)
        return [(victim, addr)]

    # -- snapshots / lifecycle -----------------------------------------------

    def state(self) -> dict:
        """Machine-readable controller snapshot — the reporter archives
        it beside the doctor verdict each tick."""
        with self._lock:
            return {
                "instances": self.launcher.active_count() + len(self.remote),
                "launched": self.launcher.active_count(),
                "remote": dict(self.remote),
                "min": self.policy.min_instances,
                "max": self.policy.max_instances,
                "verdict": self.last_verdict_kind,
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "ticks": self._ticks,
                "events": list(self.events),
            }

    # -- session snapshot (blendjax_torch.checkpoint) -------------------------

    def state_dict(self) -> dict:
        """Fleet membership for the session store: the launched
        instance count and every admitted remote member. Streaks,
        cooldowns, and the event log are deliberately transient — a
        resumed controller re-earns its scaling evidence from fresh
        verdicts instead of acting on a dead run's momentum."""
        with self._lock:
            return {
                "launched": self.launcher.active_count(),
                "remote": dict(self.remote),
            }

    def load_state_dict(self, d: dict) -> None:
        """Reconnect the fleet a snapshot describes: grow the local
        launcher back to the saved instance count (never shrink — a
        snapshot must not SIGTERM producers that outlived the
        consumer) and re-admit every saved remote member
        (``admit_remote`` is idempotent; a remote that died while the
        consumer was down simply never sends a frame and the doctor/
        lineage surface it like any silent producer)."""
        with self._lock:
            target = min(
                int(d.get("launched", 0)), self.policy.max_instances
            )
            grow = target - self.launcher.active_count()
            if grow > 0:
                self._scale_up(grow, kind="resume")
            for btid, addr in (d.get("remote") or {}).items():
                result = self.admit_remote(btid, addr)
                if not result.get("ok"):
                    # a saved member that can't re-admit must not
                    # vanish silently: name it, so a smaller resumed
                    # fleet has evidence in the log
                    logger.warning(
                        "resume: remote member %r (%s) not re-admitted:"
                        " %s", btid, addr, result.get("error"),
                    )
            self._gauge_instances()

    def scale_events(self) -> list:
        with self._lock:
            return [
                e for e in self.events
                if e["action"] in ("scale_up", "scale_down", "respawn")
            ]

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # one bad cycle must not kill the control loop — the
                # next tick re-reads fresh state
                logger.exception("fleet controller tick failed")

    def start(self) -> "FleetController":
        if self._thread is not None:
            raise RuntimeError("the fleet controller is already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="blendjax-torch-fleet-controller", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "FleetController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
