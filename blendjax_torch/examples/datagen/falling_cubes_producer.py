"""Producer: physics scene with N cubes falling under gravity.

The port of the JAX package's ``examples/datagen/falling_cubes_producer.py``,
the headless counterpart of ``falling_cubes.blend.py`` (rigid-body cubes
dropped per episode, per-instance seeds randomize the drop). Episodes
replay automatically: each episode re-randomizes positions from the
instance seed stream. Launch it with
:class:`blendjax_torch.launcher.PythonProducerLauncher`; nothing here
imports torch.
"""

from __future__ import annotations

import argparse
import sys

from blendjax_torch.transport import term_context
from blendjax_torch.producer import AnimationController, DataPublisher, parse_launch_args
from blendjax_torch.producer.sim import FallingCubesScene, SimEngine


def main() -> None:
    args, remainder = parse_launch_args(sys.argv)
    parser = argparse.ArgumentParser()
    parser.add_argument("--shape", nargs=2, type=int, default=[480, 640])
    parser.add_argument("--num-cubes", type=int, default=8)
    parser.add_argument("--episode-frames", type=int, default=100)
    parser.add_argument("--encoding", choices=["raw", "tile"], default="raw")
    parser.add_argument("--batch", type=int, default=8)
    opts = parser.parse_args(remainder)

    pub = DataPublisher(args.btsockets["DATA"], btid=args.btid, lingerms=10000)
    scene = FallingCubesScene(
        shape=tuple(opts.shape), seed=args.btseed, num_cubes=opts.num_cubes
    )
    ctrl = AnimationController(SimEngine(scene))
    if opts.encoding == "tile":
        # Sparse streaming (blendjax_torch.producer.TileBatchPublisher):
        # only tiles the cubes touch cross the wire; exact frames rebuild
        # on the consumer's card.
        from blendjax_torch.producer import TileBatchPublisher

        tiles = TileBatchPublisher(
            pub, scene.background_image(), opts.batch, tile=(16, 32),
            ref_interval=64,
        )

        def publish(f: int) -> None:
            obs = scene.observation(f)
            tiles.add(obs.pop("image"), **obs)

        ctrl.post_frame.add(publish)
    else:
        ctrl.post_frame.add(lambda f: pub.publish(**scene.observation(f)))
    try:
        ctrl.play(frame_range=(1, opts.episode_frames), num_episodes=-1)
    finally:
        pub.close()
        term_context()  # block until the tail is flushed (bounded by linger)


if __name__ == "__main__":
    main()
