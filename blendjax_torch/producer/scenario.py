"""Producer-side scenario applicator: poll, sample, apply, stamp (copied
from ``blendjax/producer/scenario.py``; numpy and zmq only).

Runs inside renderer processes (Blender's Python or the synthetic
producers of :mod:`blendjax_torch.fleet.synthetic`):

1. :meth:`ScenarioApplicator.poll` drains the duplex channel; a
   ``scenario_space`` message replaces the local copy (the latest version
   wins) and is acked with ``{"scenario_ack": version}``;
2. :meth:`ScenarioApplicator.sample` draws ``(scenario, params, theta)``
   from the latest space with the producer's own seeded generator and
   applies the params to the scene through ``apply`` (for the built-in
   scenes, ``scene.apply_scenario``);
3. :meth:`ScenarioDraw.stamp` is the ``_scenario`` message field: the
   scenario id, the space version that produced the draw and the theta
   vector, so the consumer's accounting and the curriculum's REINFORCE
   update both ride the data stream.

``wait_for_space`` holds publishing until the first space arrives, so a
newcomer's first counted frame already carries the current version.
Every ack send has a 500 ms timeout (a dead consumer must not wedge the
render loop), and a malformed or pickle-bearing control message is logged
and skipped.
"""

from __future__ import annotations

import time

import numpy as np

from blendjax_torch.scenario.accounting import SCENARIO_KEY
from blendjax_torch.scenario.space import ScenarioSpace
from blendjax_torch.utils.logging import get_logger

logger = get_logger("producer")


class ScenarioDraw:
    """One applied draw: what :meth:`ScenarioApplicator.stamp` encodes."""

    __slots__ = ("scenario", "version", "params", "theta")

    def __init__(self, scenario: str, version: int, params: dict, theta):
        self.scenario = scenario
        self.version = version
        self.params = params
        self.theta = theta

    def stamp(self) -> dict:
        s = {"id": self.scenario, "ver": int(self.version)}
        if self.theta:
            s["theta"] = [float(t) for t in self.theta]
        return s


class ScenarioApplicator:
    """Apply the consumer-published scenario space to a scene.

    - ``channel``: the producer's duplex channel
      (:class:`blendjax_torch.producer.DuplexChannel`, bind side — or any
      object with ``recv(timeoutms)``/``send(**kwargs)``).
    - ``apply``: ``fn(params: dict) -> None`` mutating the scene (the
      built-in scenes expose ``apply_scenario``).
    - ``rng``: seed (or Generator) for scenario/param draws — seeded
      from the launcher's per-instance seed ladder so producer fleets
      decorrelate deterministically.
    """

    def __init__(self, channel, apply=None, rng=0):
        self.channel = channel
        sock = getattr(channel, "sock", None)
        if sock is not None:
            # bounded ack sends: a dead consumer leaves the PAIR peer
            # mute, and a default (timeout-less) send would BLOCK the
            # render loop forever — un-drainable even on SIGTERM. The
            # consumer-side service applies the same bound.
            import zmq

            sock.setsockopt(zmq.SNDTIMEO, 500)
        self.apply = apply
        self.rng = (
            rng if isinstance(rng, np.random.Generator)
            else np.random.default_rng(rng)
        )
        self.space: ScenarioSpace | None = None
        self.version = 0
        self.last_draw: ScenarioDraw | None = None
        self.received = 0

    # -- protocol --------------------------------------------------------------

    def poll(self, timeoutms: int = 0) -> bool:
        """Drain pending duplex messages; adopt (and ack) the newest
        space. Returns True when the space changed. Non-space control
        messages are ignored (the channel may be shared with other
        producer control traffic)."""
        changed = False
        while True:
            try:
                msg = self.channel.recv(timeoutms=timeoutms)
            except Exception:
                # a malformed (or pickle-bearing, under the channel's
                # allow_pickle=False) control message is refused, not
                # fatal — but return rather than retry: a PERSISTENT
                # recv error (closed socket, ETERM) that consumes no
                # message would spin this loop at 100% CPU forever;
                # the caller's next poll retries either way (the same
                # bounded-error escape as the service-side drain).
                logger.exception("malformed scenario control message")
                return changed
            timeoutms = 0  # only the first recv may block
            if msg is None:
                return changed
            wire = msg.get("scenario_space")
            if wire is None:
                continue
            try:
                space = ScenarioSpace.from_wire(wire)
            except Exception:
                logger.exception("malformed scenario space; ignoring")
                continue
            self.received += 1
            # latest version wins; a stale re-delivery is acked anyway
            # (the consumer tracks the HIGHEST acked version)
            if self.space is None or space.version >= self.version:
                self.space = space
                self.version = space.version
                changed = True
            try:
                self.channel.send(scenario_ack=int(space.version))
            except Exception:
                # mute peer (consumer gone, pipe full past the send
                # timeout): the space was still adopted — rendering
                # continues; the consumer's wait_acked sees the gap
                logger.exception("scenario ack send failed")

    def wait_for_space(self, timeout_s: float = 15.0) -> bool:
        """Block (polling) until the first space arrives — the
        'current version before the first frame' guarantee. Returns
        False on timeout (callers degrade to unstamped publishing)."""
        deadline = time.monotonic() + timeout_s
        while self.space is None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            self.poll(timeoutms=int(min(remaining, 0.25) * 1000))
        return True

    # -- sampling --------------------------------------------------------------

    def sample(self) -> ScenarioDraw | None:
        """Draw one scenario + params from the latest space, apply it
        to the scene, and remember the draw for :meth:`stamp`. None
        while no space has arrived."""
        if self.space is None:
            return None
        name, params, theta = self.space.sample(self.rng)
        if self.apply is not None:
            self.apply(params)
        self.last_draw = ScenarioDraw(name, self.version, params, theta)
        return self.last_draw

    def next_scenario(self) -> dict:
        """Per-batch convenience: poll, sample+apply, and return the
        message fields to merge into the publish — ``{}`` while no
        space is held, ``{"_scenario": {...}}`` after."""
        self.poll()
        draw = self.sample()
        if draw is None:
            return {}
        return {SCENARIO_KEY: draw.stamp()}

    def close(self) -> None:
        self.channel.close()


__all__ = ["ScenarioApplicator", "ScenarioDraw"]
