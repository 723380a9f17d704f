"""Producer-side environment base: remote-controlled simulation episodes
(copied from ``blendjax/producer/env.py``).

A blocking REQ/REP rendezvous inside a frame-callback world: one remote
``step()`` is one simulated frame, split into a pre-frame half (apply the
action) and a post-frame half (collect the observation) so the physics
resolves in between. :class:`RemoteControlledAgent` is the REP side's
state machine: it owes a reply after every accepted request, sends the
fresh context at the next frame boundary, then waits for the next
command. ``real_time=True`` receives without blocking and steps with no
action while the consumer is slow, so the simulation clock never stalls.

Every reply goes over the tensor codec without pickles: observations are
ndarrays, ``reward`` a float, ``done`` a bool (``_wire_ctx``), ``time``
an int.
"""

from __future__ import annotations

import time

from blendjax_torch import constants
from blendjax_torch.producer.animation import AnimationController, Engine
from blendjax_torch.transport import RpcServer

CMD_STEP = "step"
CMD_RESTART = "restart"


class BaseEnv:
    """Wire an agent into the animation lifecycle.

    Subclasses implement ``_env_reset()`` (reset the scene at an episode
    start), ``_env_prepare_step(action)`` (apply the action before the
    physics) and ``_env_post_step()`` (the post-physics context dict:
    ``obs``, ``reward``, ``done`` and extras).
    """

    def __init__(self, agent):
        self.agent = agent
        self.events: AnimationController | None = None
        self.ctx: dict = {}
        self.renderer = None
        self.render_every: int = 1

    def run(self, engine: Engine, frame_range=(1, 2_147_483_647)) -> None:
        """Play frames under ``engine`` until cancelled."""
        self.events = AnimationController(engine)
        self.events.pre_frame.add(self._pre_frame)
        self.events.pre_animation.add(self._pre_animation)
        self.events.post_frame.add(self._post_frame)
        self.events.play(frame_range=frame_range, num_episodes=-1)

    def attach_default_renderer(self, every_nth: int = 1, renderer=None):
        """Attach an rgb renderer whose frame rides along as ``rgb_array``
        every ``every_nth`` frames; ``renderer=None`` takes
        :meth:`_default_renderer` (a sim env's scene renderer, or
        Blender's offscreen renderer)."""
        self.renderer = renderer or self._default_renderer()
        if self.renderer is None:
            raise ValueError(
                "no renderer: pass renderer=... or override _default_renderer"
            )
        self.render_every = max(1, int(every_nth))

    def _default_renderer(self):
        """A zero-argument callable giving an (H, W, C) uint8 frame, or
        None. Under Blender, the offscreen Eevee renderer."""
        try:
            from blendjax_torch.producer.offscreen import OffScreenRenderer

            return OffScreenRenderer().render
        except ImportError:
            return None

    def stop(self) -> None:
        if self.events is not None:
            self.events.cancel()

    # -- signal handlers ----------------------------------------------------

    def _pre_animation(self) -> None:
        # episode start: a parked reset seed lands before the reset
        self.ctx = {}
        seed = getattr(self.agent, "reset_seed", None)
        if seed is not None:
            self.agent.reset_seed = None
            self._env_seed(seed)
        self._env_reset()

    def _pre_frame(self, frame: int) -> None:
        cmd, action = self.agent(self, **self.ctx)
        if cmd == CMD_RESTART:
            self.events.rewind()
        elif cmd == CMD_STEP:
            if action is not None:
                self._env_prepare_step(action)
            self.ctx["time"] = frame  # simulation time is the frame

    def _post_frame(self, frame: int) -> None:
        if self.renderer is not None and frame % self.render_every == 0:
            self.ctx["rgb_array"] = self.renderer()
        self.ctx.update(self._env_post_step())

    # -- implemented by scene envs ------------------------------------------

    def _env_seed(self, seed: int) -> None:
        """Reseed the episode RNG before ``_env_reset``: by default the
        ``reseed`` hook of ``self.scene`` where it has one."""
        scene = getattr(self, "scene", None)
        reseed = getattr(scene, "reseed", None)
        if reseed is not None:
            reseed(seed)

    def _env_reset(self) -> None:
        raise NotImplementedError

    def _env_prepare_step(self, action) -> None:
        raise NotImplementedError

    def _env_post_step(self) -> dict:
        raise NotImplementedError


class RemoteControlledAgent:
    """REP-side state machine bridging blocking remote calls to frames."""

    STATE_INIT = 0  # nothing received yet this episode
    STATE_REQ = 1  # waiting for the next command
    STATE_REP = 2  # a reply is owed after the current frame

    def __init__(
        self,
        bind_addr: str,
        real_time: bool = False,
        timeoutms: int = constants.DEFAULT_PRODUCER_TIMEOUTMS,
    ):
        self.server = RpcServer(bind_addr)
        self.addr = self.server.addr
        self.real_time = real_time
        self.timeoutms = timeoutms
        self.state = self.STATE_INIT
        # a reset(seed=) parks its seed here until the next episode start
        # consumes it (BaseEnv._pre_animation)
        self.reset_seed: int | None = None

    def __call__(self, env: BaseEnv, **ctx):
        if self.state == self.STATE_REP:
            if not ctx:
                # a reply is owed but the fresh episode has no observation
                # yet (pre_animation cleared ctx): step once with no
                # action, reply at the next frame
                return CMD_STEP, None
            self.server.reply(**self._wire_ctx(ctx))
            self.state = self.STATE_REQ

        req = self._next_request(env)
        if req is None:
            # real time only: the consumer is slow, free-run a step
            return CMD_STEP, None

        cmd = req.get("cmd")
        if cmd == "reset":
            seed = req.get("seed")
            if seed is not None:
                self.reset_seed = int(seed)
            if self.state == self.STATE_INIT and seed is None:
                # the episode just started and nothing was stepped: step
                # once so there is an observation to reply with, without
                # rewinding again. A seeded reset always rewinds: the
                # episode that just started drew from the launch seed.
                self.state = self.STATE_REP
                return CMD_STEP, None
            self.state = self.STATE_REP
            return CMD_RESTART, None
        if cmd == "step":
            self.state = self.STATE_REP
            return CMD_STEP, req.get("action")
        # unknown command: reply with an error, keep waiting next frame
        self.server.reply(error=f"unknown cmd {cmd!r}")
        return CMD_STEP, None

    def _next_request(self, env: BaseEnv):
        if self.real_time:
            return self.server.recv(timeoutms=0)
        # blocking: wait in pollable slices, so a cancel is honoured
        while True:
            req = self.server.recv(timeoutms=min(self.timeoutms, 100))
            if req is not None:
                return req
            if env.events is not None and env.events.cancelled:
                return None
            time.sleep(0)

    @staticmethod
    def _wire_ctx(ctx: dict) -> dict:
        # a plain bool for the wire: user env code hands numpy bools
        out = dict(ctx)
        if "done" in out:
            out["done"] = bool(out["done"])
        return out

    def close(self) -> None:
        self.server.close()
