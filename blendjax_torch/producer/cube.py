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
``--wire`` picks the encoding: ``raw`` (default), zlib ``ndz``,
run-length ``ndr`` (``--rle-cap N`` pins its capacity) or ``shm``, a
shared-memory ring of 4 slots for a consumer on this host (a ring that
cannot be created stops the producer). Under ``$BLENDJAX_SHM_REGISTRY``
the ring is registered there for the launcher to unlink; otherwise the
producer unlinks it when it ends normally.

With ``--tile-rgba`` (full-channel tiles) on the native path, the tile
scan and the palettizer run fused, one colour table per frame (the JAX
package's per-frame palette form). Rendering, the changed-tile scan and
the palettizers run in the port's host C++ (``blendjax_torch/_native``, built with g++ at first use; a failed
build stops the producer). ``--no-native`` is for a host without a C++
compiler: the producer then runs the numpy twins, at about a twentieth of
the rate, instead of stopping.
On stderr the producer says once, at start, which path it runs (a line
``blendjax_torch.producer.cube path native ...`` or ``... path numpy``),
and every 64 frames prints ``blendjax_torch.producer.cube stats`` and a
JSON object of its totals: frames, the ms per frame spent rendering,
encoding and publishing (serialising and sending: the send waits while the
consumer's queue is full, so a long publish means the consumer is the
bound), its own rate without the publish (``own_frames_s``), its wire
with the shared-memory ring's fallbacks and reclaims, whether the fused
path is on (``fused``) and the mean array bytes per message
(``msg_bytes``, the reference image left out) with ``frames_per_msg``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

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
    parser.add_argument(
        "--wire", choices=("raw", "ndz", "ndr", "shm"), default="raw",
        help="raw frames (default); zlib 'ndz' (inflated on the "
        "consumer's host); run-length 'ndr' (expanded inside the fused "
        "train step); 'shm' writes the arrays into a shared-memory ring "
        "for a consumer on this host and sends only a descriptor",
    )
    parser.add_argument(
        "--rle-cap", type=int, default=0, metavar="N",
        help="pin the ndr per-row pair capacity, so the consumer's packed "
        "shapes never change; 0 = a sticky per-key capacity",
    )
    parser.add_argument("--no-native", action="store_true",
                        help="render, scan and palettize with the numpy "
                        "twins instead of the host C++ (for a host without "
                        "g++)")
    opts = parser.parse_args(argv)
    if opts.batch < 2:
        parser.error("--encoding tile requires --batch > 1")
    if len(opts.tile) > 2:
        parser.error("--tile takes one side or two (rows cols) values")
    return opts


REPORT_EVERY = 64  # frames between two stats lines on stderr


class _TimedPublisher:
    """The socket's ``publish``, with the seconds spent in it summed, and
    the messages and their array bytes counted (the reference image that
    rides on every ``ref_interval``-th message left out)."""

    def __init__(self, pub):
        self.pub = pub
        self.seconds = 0.0
        self.messages = 0
        self.array_bytes = 0

    def publish(self, **msg) -> None:
        self.messages += 1
        self.array_bytes += sum(
            v.nbytes for k, v in msg.items()
            if isinstance(v, np.ndarray) and not k.endswith("__tileref"))
        t0 = time.perf_counter()
        self.pub.publish(**msg)
        self.seconds += time.perf_counter() - t0


def wire_kwargs(opts) -> dict:
    """The publisher's wire settings for ``--wire`` (the mapping of the
    JAX package's synthetic producer). Tile messages are prebatched
    whatever the wire."""
    kw = {}
    if opts.wire in ("ndz", "ndr"):
        kw["compress_min_bytes"] = 1024
    if opts.wire == "ndz":
        kw["compress_level"] = 6
    elif opts.wire == "ndr":
        kw["compress_rle"] = True
        kw["rle_cap"] = opts.rle_cap or None
    elif opts.wire == "shm":
        kw["shm"] = 4
    return kw


def _say(line: str) -> None:
    print(f"blendjax_torch.producer.cube {line}", file=sys.stderr, flush=True)


def main(argv=None) -> None:
    opts = parse_args(argv)
    native = not opts.no_native
    scene = CubeScene(shape=tuple(opts.shape), seed=opts.seed, native=native)
    if native:
        from blendjax_torch._native.build import paths

        libs = paths()
        _say(f"path native: C++ render, tile scan and palettizer "
             f"({libs['rasterizer']}, {libs['tiledelta']})")
    else:
        _say("path numpy: numpy render, tile scan and palettizer")
    pub = DataPublisherSocket(opts.bind, btid=opts.btid, lingerms=10000,
                              send_hwm=2, **wire_kwargs(opts))
    if opts.addr_file:
        tmp = f"{opts.addr_file}.tmp"
        with open(tmp, "w") as f:
            f.write(pub.addr)
        os.replace(tmp, opts.addr_file)
    timed = _TimedPublisher(pub)
    tile = opts.tile[0] if len(opts.tile) == 1 else tuple(opts.tile)
    tiles = TileBatchPublisher(
        timed, scene.background_image(), opts.batch, tile=tile,
        alpha_slice=not opts.tile_rgba, ref_interval=opts.ref_interval,
        capacity=opts.tile_capacity or None, native=native,
    )
    h, w = opts.shape
    framebuf = np.empty((h, w, 4), np.uint8)
    frame = 1
    render_s = add_s = 0.0
    try:
        while opts.frames <= 0 or frame <= opts.frames:
            t0 = time.perf_counter()
            scene.step(frame)
            scene.render(out=framebuf)
            t1 = time.perf_counter()
            tiles.add(
                framebuf,
                # outside the rect just drawn the frame is background
                hint=scene.raster.last_drawn,
                xy=scene.camera.world_to_pixel(
                    scene.corners_world()
                ).astype(np.float32),
                frameid=np.int64(frame),
            )
            t2 = time.perf_counter()
            render_s += t1 - t0
            add_s += t2 - t1
            if frame % REPORT_EVERY == 0:
                encode_s = add_s - timed.seconds
                _say("stats " + json.dumps({
                    "btid": opts.btid, "path": "native" if native else "numpy",
                    "frames": frame,
                    "render_ms": render_s / frame * 1e3,
                    "encode_ms": encode_s / frame * 1e3,
                    "publish_ms": timed.seconds / frame * 1e3,
                    "own_frames_s": frame / (render_s + encode_s),
                    "wire": opts.wire,
                    "fused": tiles._fused_ok,
                    "msg_bytes": timed.array_bytes / max(timed.messages, 1),
                    "frames_per_msg": opts.batch,
                    "shm_fallbacks": pub.shm_fallbacks,
                    "shm_reclaims": pub.shm_reclaims,
                }))
            frame += 1
        tiles.flush()
    finally:
        pub.close()
        term_context()  # block until the tail is flushed (bounded by linger)


if __name__ == "__main__":
    main()
