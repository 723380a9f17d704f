"""Producer: renders supershapes whose parameters arrive over the duplex
control channel.

The port of the JAX package's ``examples/densityopt/supershape_producer.py``,
the headless counterpart of ``supershape.blend.py``: ``pre_frame`` polls
CTRL non-blocking for new ``(shape_params, shape_id)``, ``post_frame``
publishes ``(image, shape_id)`` so the consumer can re-associate renders
with the parameter samples that produced them. Nothing here imports torch.
"""

from __future__ import annotations

import sys
import time
from collections import deque

import numpy as np

from blendjax_torch.transport import term_context
from blendjax_torch.producer import (
    AnimationController,
    DataPublisher,
    DuplexChannel,
    parse_launch_args,
)
from blendjax_torch.producer.sim import SimEngine, SupershapeScene


def main() -> None:
    args, _ = parse_launch_args(sys.argv)
    pub = DataPublisher(args.btsockets["DATA"], btid=args.btid, lingerms=10000)
    ctrl = DuplexChannel(args.btsockets["CTRL"], btid=args.btid)
    scene = SupershapeScene(seed=args.btseed)
    pending: deque = deque()
    fresh = False

    def pre_frame(frame: int) -> None:
        nonlocal fresh
        # Drain all queued param updates, keep them in arrival order.
        while True:
            msg = ctrl.recv(timeoutms=0)
            if msg is None:
                break
            pending.append(
                (np.asarray(msg["shape_params"]), int(msg["shape_id"]))
            )
        if pending:
            params, sid = pending.popleft()
            scene.set_params(params, sid)
            fresh = True
        else:
            fresh = False
            time.sleep(0.001)  # idle: don't spin the frame loop hot

    def post_frame(frame: int) -> None:
        # One published render per parameter sample, so the consumer's
        # image count matches the samples it fanned out.
        if fresh and scene.shape_id >= 0:
            pub.publish(**scene.observation(frame))

    ctrl_engine = SimEngine(scene)
    ctl = AnimationController(ctrl_engine)
    ctl.pre_frame.add(pre_frame)
    ctl.post_frame.add(post_frame)
    try:
        ctl.play(frame_range=(1, 2_147_483_647), num_episodes=-1)
    finally:
        pub.close()
        ctrl.close()
        term_context()  # block until the tail is flushed (bounded by linger)


if __name__ == "__main__":
    main()
