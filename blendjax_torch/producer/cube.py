"""Cube producer process: streams tile-delta batches of the rotating cube.

The port's copy of the tile branch of ``examples/datagen/cube_producer.py``.
Every frame the scene is re-randomised, rendered into a reused
framebuffer, scanned for tiles that differ from the background, and added
to a :class:`~blendjax_torch.producer.TileBatchPublisher`, which pushes one
prebatched message per ``--batch`` frames.

    python -m blendjax_torch.producer.cube --bind 'tcp://127.0.0.1:*' \\
        --addr-file /tmp/p0.addr --btid 0 --seed 0 --shape 480 640 \\
        --batch 8 --encoding tile --tile 16 32 --tile-rgba --tile-capacity 160

The bound address (wildcard ports resolve at bind time) is written to
``--addr-file`` so the consumer can connect. ``--frames N`` stops after N
frames and flushes the partial batch; the default streams until killed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from blendjax_torch.producer.sim import CubeScene
from blendjax_torch.producer.tile_publisher import TileBatchPublisher
from blendjax_torch.transport import DataPublisherSocket, term_context


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--bind", default="tcp://127.0.0.1:*")
    parser.add_argument("--addr-file", default=None,
                        help="write the bound address here")
    parser.add_argument("--btid", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--shape", nargs=2, type=int, default=[480, 640])
    parser.add_argument("--frames", type=int, default=-1)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--encoding", choices=["tile"], default="tile")
    parser.add_argument("--tile", nargs="+", type=int, default=[16, 32],
                        help="one side (square) or rows cols")
    parser.add_argument("--tile-rgba", action="store_true",
                        help="ship full RGBA tiles even when alpha is static")
    parser.add_argument("--ref-interval", type=int, default=64,
                        help="re-send the reference every N batches; 0 = once")
    parser.add_argument("--tile-capacity", type=int, default=0,
                        help="pin the per-frame changed-tile capacity "
                        "(0 = per-stream high-water mark)")
    opts = parser.parse_args(argv)
    if opts.batch < 2:
        parser.error("--encoding tile requires --batch > 1")
    if len(opts.tile) > 2:
        parser.error("--tile takes one side or two (rows cols) values")
    return opts


def main(argv=None) -> None:
    opts = parse_args(argv)
    scene = CubeScene(shape=tuple(opts.shape), seed=opts.seed)
    pub = DataPublisherSocket(opts.bind, btid=opts.btid, lingerms=10000,
                              send_hwm=2)
    if opts.addr_file:
        tmp = f"{opts.addr_file}.tmp"
        with open(tmp, "w") as f:
            f.write(pub.addr)
        os.replace(tmp, opts.addr_file)
    tile = opts.tile[0] if len(opts.tile) == 1 else tuple(opts.tile)
    tiles = TileBatchPublisher(
        pub, scene.background_image(), opts.batch, tile=tile,
        alpha_slice=not opts.tile_rgba, ref_interval=opts.ref_interval,
        capacity=opts.tile_capacity or None,
    )
    h, w = opts.shape
    framebuf = np.empty((h, w, 4), np.uint8)
    frame = 1
    try:
        while opts.frames <= 0 or frame <= opts.frames:
            scene.step(frame)
            scene.render(out=framebuf)
            tiles.add(
                framebuf,
                # outside the rect just drawn the frame is background
                hint=scene.raster.last_drawn,
                xy=scene.camera.world_to_pixel(
                    scene.corners_world()
                ).astype(np.float32),
                frameid=np.int64(frame),
            )
            frame += 1
        tiles.flush()
    finally:
        pub.close()
        term_context()  # block until the tail is flushed (bounded by linger)


if __name__ == "__main__":
    main()
