"""Animation lifecycle controller: the producer's main loop (copied from
``blendjax/producer/animation.py``).

It turns a frame-stepped simulation into deterministic lifecycle events::

    pre_play -> [pre_animation -> (pre_frame -> post_frame) x N
                 -> post_animation] x E -> post_play

where an episode is one replay of the frame range. The loop runs over an
:class:`Engine`: the headless :class:`~blendjax_torch.producer.sim.SimEngine`
or Blender's (:class:`~blendjax_torch.producer.bpy_engine.BpyEngine`).
Each frame's ``frame_set`` is timed as the ``producer.frame`` span, which
the publishers' telemetry snapshots carry to the consumer.
"""

from __future__ import annotations

from blendjax_torch.producer.signal import Signal
from blendjax_torch.utils.metrics import metrics


class Engine:
    """What the controller needs from a renderer or simulator.

    ``frame_set(i)`` advances the scene to frame ``i``; the controller
    invokes ``pre_frame`` before it and ``post_frame`` after it, so an
    action applied in ``pre_frame`` is resolved before ``post_frame``
    observes (the contract of the env layer).
    """

    def frame_set(self, frame: int) -> None:
        raise NotImplementedError

    def reset(self) -> None:
        """Rewind the scene to the start of the frame range."""


class CancelledError(Exception):
    """Raised internally to unwind a cancelled play loop."""


class AnimationController:
    """Drives episodes of a frame range over an :class:`Engine`.

    Signals: ``pre_play``, ``pre_animation``, ``pre_frame``, ``post_frame``,
    ``post_animation``, ``post_play``; the frame handlers receive the
    current frame number.
    """

    def __init__(self, engine: Engine):
        self.engine = engine
        self.pre_play = Signal()
        self.pre_animation = Signal()
        self.pre_frame = Signal()
        self.post_frame = Signal()
        self.post_animation = Signal()
        self.post_play = Signal()
        self.frameid: int | None = None
        self.episode = 0
        self._playing = False
        self._rewind_requested = False
        self._cancel_requested = False

    @property
    def playing(self) -> bool:
        return self._playing

    @property
    def cancelled(self) -> bool:
        """True once :meth:`cancel` was requested (lets a long-blocking
        frame handler, such as the env's RPC wait, bail out)."""
        return self._cancel_requested

    def rewind(self) -> None:
        """Restart the current episode's frame range at the next frame
        boundary; callable from ``pre_frame`` / ``post_frame`` handlers."""
        self._rewind_requested = True

    def cancel(self) -> None:
        """Stop playing after the current frame."""
        self._cancel_requested = True

    def play(self, frame_range=(1, 250), num_episodes: int = -1,
             use_animation: bool | None = None) -> None:
        """Blocking play loop; ``num_episodes=-1`` plays until
        :meth:`cancel`. ``use_animation`` is accepted for the reference's
        call shape and ignored."""
        del use_animation
        if self._playing:
            raise RuntimeError("already playing")
        start, end = int(frame_range[0]), int(frame_range[1])
        if end < start:
            raise ValueError(f"invalid frame range {frame_range}")
        self._playing = True
        self._cancel_requested = False
        self.episode = 0
        self.pre_play.invoke()
        try:
            self._run_loop(start, end, num_episodes)
        except CancelledError:
            pass
        finally:
            self._playing = False
            self.post_play.invoke()

    def _run_loop(self, start: int, end: int, num_episodes: int) -> None:
        while num_episodes < 0 or self.episode < num_episodes:
            self._play_episode(start, end)
            self.episode += 1
            if self._cancel_requested:
                break

    def _play_episode(self, start: int, end: int) -> None:
        self.engine.reset()
        self.pre_animation.invoke()
        frame = start
        while frame <= end:
            self._rewind_requested = False
            self.frameid = frame
            self.pre_frame.invoke(frame)
            with metrics.span("producer.frame"):
                self.engine.frame_set(frame)
            self.post_frame.invoke(frame)
            if self._cancel_requested:
                raise CancelledError
            if self._rewind_requested:
                # restart the range without closing the episode;
                # pre_animation fires again so the env's reset hooks run
                self.engine.reset()
                self.pre_animation.invoke()
                frame = start
                continue
            frame += 1
        self.post_animation.invoke()
