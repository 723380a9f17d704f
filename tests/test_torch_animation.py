"""The port's animation controller and signals against the JAX package's,
on the CPU: the same scripted run (episodes of a frame range, a rewind
requested from a frame handler, a cancel) gives the same sequence of
lifecycle callbacks and engine calls on both packages."""

import pytest

from blendjax.producer import animation as JA
from blendjax.producer import signal as JSig
from blendjax_torch.producer import animation as TA
from blendjax_torch.producer import signal as TSig


class _Engine:
    """Records the controller's engine calls into the shared log."""

    def __init__(self, log):
        self.log = log

    def frame_set(self, frame):
        self.log.append(f"frame_set:{frame}")

    def reset(self):
        self.log.append("reset")


def _run(mod, frame_range, episodes, rewind_at=None, cancel_at=None):
    """Play a scripted run; returns the callback log and the final
    controller state."""
    log = []
    engine = type("E", (_Engine, mod.Engine), {})(log)
    ctrl = mod.AnimationController(engine)
    rewound = []
    ctrl.pre_play.add(lambda: log.append("pre_play"))
    ctrl.pre_animation.add(lambda: log.append(f"pre_animation:{ctrl.episode}"))

    def pre_frame(frame):
        log.append(f"pre_frame:{frame}:{ctrl.frameid}")
        if (ctrl.episode, frame) == rewind_at and not rewound:
            rewound.append(frame)
            ctrl.rewind()

    def post_frame(frame):
        log.append(f"post_frame:{frame}")
        if (ctrl.episode, frame) == cancel_at:
            ctrl.cancel()
            log.append(f"cancelled:{ctrl.cancelled}")

    ctrl.pre_frame.add(pre_frame)
    ctrl.post_frame.add(post_frame)
    ctrl.post_animation.add(lambda: log.append("post_animation"))
    ctrl.post_play.add(lambda: log.append(f"post_play:{ctrl.playing}"))
    ctrl.play(frame_range=frame_range, num_episodes=episodes)
    return log, (ctrl.episode, ctrl.frameid, ctrl.playing)


@pytest.mark.parametrize("script", [
    dict(frame_range=(1, 3), episodes=2),
    dict(frame_range=(1, 4), episodes=2, rewind_at=(1, 2)),
    dict(frame_range=(1, 4), episodes=-1, cancel_at=(1, 3)),
    dict(frame_range=(5, 7), episodes=2, rewind_at=(0, 6), cancel_at=(1, 5)),
    dict(frame_range=(2, 2), episodes=3),
], ids=["two-episodes", "rewind", "cancel", "rewind-and-cancel", "one-frame"])
def test_the_callback_sequence_is_the_reference(script):
    port = _run(TA, **script)
    ref = _run(JA, **script)
    assert port == ref
    log = port[0]
    assert log[0] == "pre_play" and log[-1] == "post_play:False"
    if "rewind_at" in script:
        # the rewind restarts the range without closing the episode: the
        # engine resets and pre_animation fires again
        assert log.count("post_animation") < log.count("reset")


def test_the_two_episode_lifecycle_of_the_reference_fixture():
    """The sequence ``tests/blender/anim.blend.py`` asserts, on the port."""
    log, _ = _run(TA, (1, 3), 2)
    episode = lambda e: (["reset", f"pre_animation:{e}"] + [  # noqa: E731
        s for f in (1, 2, 3)
        for s in (f"pre_frame:{f}:{f}", f"frame_set:{f}", f"post_frame:{f}")
    ] + ["post_animation"])
    assert log == ["pre_play"] + episode(0) + episode(1) + ["post_play:False"]


def test_the_frame_span_counts_each_frame():
    from blendjax_torch.utils.metrics import metrics

    metrics.reset()
    _run(TA, (1, 4), 2)
    assert metrics.report()["spans"]["producer.frame"]["count"] == 8


def test_play_refuses_what_the_reference_asserts():
    ctrl = TA.AnimationController(TA.Engine())
    with pytest.raises(ValueError, match="frame range"):
        ctrl.play(frame_range=(3, 1))
    with pytest.raises(NotImplementedError):
        ctrl.play(frame_range=(1, 1), num_episodes=1)
    assert not ctrl.playing


@pytest.mark.parametrize("mod", [TSig, JSig], ids=["port", "jax"])
def test_signal_binds_removes_and_invokes_in_order(mod):
    sig = mod.Signal()
    got = []
    a = sig.add(lambda x: got.append(("a", x)))
    b = sig.add(lambda tag, x, scale=1: got.append((tag, x * scale)), "b",
                scale=10)
    sig.invoke(2)
    sig.remove(a)
    sig.invoke(3)
    assert got == [("a", 2), ("b", 20), ("b", 30)]
    assert len(sig) == 1 and b in sig._slots
    sig.clear()
    sig.invoke(4)
    assert len(sig) == 0 and len(got) == 3
