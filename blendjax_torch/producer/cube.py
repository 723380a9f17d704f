"""Cube producer process: streams the rotating cube as raw frames, tile
deltas or palette-compressed frames.

The port of ``examples/datagen/cube_producer.py``, with every flag of it
and its meaning. The frames run through an
:class:`~blendjax_torch.producer.AnimationController` over a
:class:`~blendjax_torch.producer.sim.SimEngine`: each frame the engine
re-randomises the scene, and a ``post_frame`` handler publishes it by
``--encoding``:

- ``raw`` (the default): with ``--batch 1`` (its default) one message per
  frame; with ``--batch B > 1`` one ``(B, H, W, 4)`` message per ``B``
  frames, rendered straight into a pool of batch buffers that a slot
  reuses only once the socket is done with it (``publish_tracked``);
- ``tile``: the frame is rendered into a reused framebuffer, scanned for
  tiles that differ from the background and added to a
  :class:`~blendjax_torch.producer.TileBatchPublisher`, which pushes one
  prebatched message per ``--batch`` frames (needs ``--batch > 1``);
- ``pal``: ``--batch`` whole frames are palette-compressed, one palette per
  frame (:func:`blendjax_torch.ops.tiles.palettize_frames`), and pushed as
  one prebatched message; a batch with a frame of more than 256 colours
  goes raw (needs ``--batch > 1``).

Started by hand, it binds ``--bind`` and takes ``--btid`` and ``--seed``:

    python -m blendjax_torch.producer.cube --bind 'tcp://127.0.0.1:*' \\
        --addr-file p0.addr --btid 0 --seed 0 --shape 480 640 \\
        --batch 8 --encoding tile --tile 16 32 --tile-rgba --tile-capacity 160

Started by a launcher (``PythonProducerLauncher(script=<this file>,
named_sockets=["DATA"])``), it reads the handshake after ``--``
(``-btid``, ``-btseed``, ``-btsockets DATA=...``), which takes the place
of those three flags; the flags of ``instance_args`` follow it.

The bound address (wildcard ports resolve at bind time) is written to
``--addr-file`` so the consumer can connect. ``--frames N`` stops after N
frames and flushes the partial batch; the default streams until killed.
``--wire`` picks the wire form of every encoding: ``raw`` (default), zlib ``ndz``,
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
On stderr (or appended to ``--log FILE``) the producer says once, at
start, which path it runs (a line
``blendjax_torch.producer.cube path native ...`` or ``... path numpy``),
and every 64 frames prints ``blendjax_torch.producer.cube stats`` and a
JSON object of its btid, seed and encoding and its totals: frames, the ms
per frame spent rendering, encoding and publishing (serialising and sending: the send waits while the
consumer's queue is full, so a long publish means the consumer is the
bound), its own rate without the publish (``own_frames_s``), its wire
with the shared-memory ring's fallbacks and reclaims, whether the fused
path is on (``fused``) and the mean array bytes per message
(``msg_bytes``, the reference image left out) with ``frames_per_msg``.
The publisher stamps lineage, a telemetry snapshot every 64 messages
(carrying the controller's ``producer.frame`` span, the scene step) and a
sampled frame trace every ``--trace-every`` messages (64; 0 stamps none).
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    # Run as a file (a launcher's way), this directory is sys.path[0],
    # where producer/signal.py would shadow the standard library's signal.
    _here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.curdir) != _here]

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from blendjax_torch.launcher.arguments import parse_launch_args  # noqa: E402
from blendjax_torch.producer.animation import AnimationController  # noqa: E402
from blendjax_torch.producer.sim import CubeScene, SimEngine  # noqa: E402
from blendjax_torch.producer.tile_publisher import TileBatchPublisher  # noqa: E402
from blendjax_torch.transport import DataPublisherSocket, term_context  # noqa: E402


def parse_args(argv=None):
    """The producer's options; with a launcher's handshake after ``--``,
    its btid, seed and ``DATA`` address replace ``--btid``, ``--seed`` and
    ``--bind``, and the user flags after the handshake are parsed with the
    ones before ``--``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    launch = None
    if "--" in argv:
        launch, remainder = parse_launch_args(argv)
        argv = argv[:argv.index("--")] + remainder
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--bind", default="tcp://127.0.0.1:*")
    parser.add_argument("--addr-file", default=None,
                        help="write the bound address here")
    parser.add_argument("--log", default=None, metavar="FILE",
                        help="append the path and stats lines to FILE "
                        "instead of stderr")
    parser.add_argument("--btid", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--shape", nargs=2, type=int, default=[480, 640])
    parser.add_argument("--frames", type=int, default=-1)
    parser.add_argument(
        "--batch", type=int, default=1,
        help="publish one (B, H, W, 4) message per B frames instead of B "
        "per-frame messages (renders straight into the batch buffer)")
    parser.add_argument(
        "--encoding", choices=["raw", "tile", "pal"], default="raw",
        help="'raw' ships full frames; 'tile' ships only the tiles that "
        "changed against the scene background (lossless; decoded on the "
        "card by the consumer); 'pal' palette-compresses whole frames. "
        "'tile' and 'pal' need --batch > 1")
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
        "--trace-every", type=int, default=64,
        help="stamp every Nth published message with a sampled "
        "distributed-trace context (blendjax_torch.obs.trace). 0 disables.")
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
    if launch is not None:
        if "DATA" not in launch.btsockets:
            parser.error("the launch handshake names no DATA socket")
        opts.bind = launch.btsockets["DATA"]
        opts.btid = launch.btid
        opts.seed = launch.btseed
    if opts.encoding != "raw" and opts.batch < 2:
        parser.error(f"--encoding {opts.encoding} requires --batch > 1")
    if opts.batch < 1:
        parser.error("--batch must be at least 1")
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

    def _count(self, msg: dict) -> None:
        self.messages += 1
        self.array_bytes += sum(
            v.nbytes for k, v in msg.items()
            if isinstance(v, np.ndarray) and not k.endswith("__tileref"))

    def publish(self, **msg) -> None:
        self._count(msg)
        t0 = time.perf_counter()
        self.pub.publish(**msg)
        self.seconds += time.perf_counter() - t0

    def publish_tracked(self, **msg):
        self._count(msg)
        t0 = time.perf_counter()
        tracker = self.pub.publish_tracked(**msg)
        self.seconds += time.perf_counter() - t0
        return tracker


def wire_kwargs(opts) -> dict:
    """The publisher's wire settings for ``--wire`` (the mapping of the
    JAX package's synthetic producer). Tile and palette messages are
    prebatched whatever the wire."""
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


def _say(line: str, log: str | None = None) -> None:
    line = f"blendjax_torch.producer.cube {line}"
    if log is None:
        print(line, file=sys.stderr, flush=True)
    else:
        with open(log, "a") as f:
            f.write(line + "\n")


def _tile_publish(opts, scene, timed, native, mark):
    """``(publish(frame), flush, fused)`` of ``--encoding tile``; each
    helper calls ``mark()`` once the frame is rendered."""
    h, w = opts.shape
    tile = opts.tile[0] if len(opts.tile) == 1 else tuple(opts.tile)
    tiles = TileBatchPublisher(
        timed, scene.background_image(), opts.batch, tile=tile,
        alpha_slice=not opts.tile_rgba, ref_interval=opts.ref_interval,
        capacity=opts.tile_capacity or None, native=native,
    )
    framebuf = np.empty((h, w, 4), np.uint8)

    def publish(frame: int) -> None:
        scene.render(out=framebuf)
        mark()
        tiles.add(
            framebuf,
            # outside the rect just drawn the frame is background
            hint=scene.raster.last_drawn,
            xy=scene.camera.world_to_pixel(
                scene.corners_world()
            ).astype(np.float32),
            frameid=np.int64(frame),
        )

    return publish, tiles.flush, lambda: tiles._fused_ok


def _batch_buffers(b: int, h: int, w: int) -> dict:
    return {"image": np.empty((b, h, w, 4), np.uint8),
            "xy": np.empty((b, 8, 2), np.float32),
            "frameid": np.empty((b,), np.int64)}


def _pal_publish(opts, scene, timed, mark):
    """``(publish(frame), flush)`` of ``--encoding pal``: whole frames,
    one palette per frame, raw when a frame outgrows 256 colours."""
    from blendjax_torch.ops.tiles import (
        FRAMEPAL_SUFFIXES,
        FRAMESHAPE_SUFFIX,
        PALETTE_SUFFIX,
        palettize_frames,
    )

    b, (h, w) = opts.batch, opts.shape
    buf = _batch_buffers(b, h, w)
    cursor = {"i": 0}

    def ship(filled: dict) -> None:
        # the socket sends arrays by reference: what the next frame
        # renders into again (xy, frameid, the whole batch when it goes
        # raw) is copied; packed and palette are fresh per batch
        out = palettize_frames(filled["image"])
        if out is None:  # the scene outgrew the palette: stay lossless
            timed.publish(_batched=True,
                          **{k: v.copy() for k, v in filled.items()})
            return
        packed, pal, bits = out
        timed.publish(
            _prebatched=True,
            **{"image" + FRAMEPAL_SUFFIXES[bits]: packed,
               "xy": filled["xy"].copy(),
               "frameid": filled["frameid"].copy(),
               "image" + PALETTE_SUFFIX: pal,
               "image" + FRAMESHAPE_SUFFIX: np.array([h, w, 4, bits],
                                                     np.int32)},
        )

    def publish(frame: int) -> None:
        scene.observation_into(frame, buf, cursor["i"])
        mark()
        cursor["i"] += 1
        if cursor["i"] == b:
            ship(buf)
            cursor["i"] = 0

    def flush() -> None:
        i = cursor["i"]
        if i > 0:
            ship({k: v[:i] for k, v in buf.items()})

    return publish, flush


def _raw_publish(opts, scene, timed, send_hwm: int, mark):
    """``(publish(frame), flush)`` of ``--encoding raw``: per-frame
    messages, or with ``--batch B > 1`` a pool of ``send_hwm + 2`` batch
    buffers (queued, in flight, being rendered), a slot rendered into again
    only once its tracker says the socket is done with it."""
    b, (h, w) = opts.batch, opts.shape
    if b == 1:
        def publish(frame: int) -> None:
            obs = scene.observation(frame)
            mark()
            timed.publish(**obs)

        return publish, None
    pool = [_batch_buffers(b, h, w) for _ in range(send_hwm + 2)]
    trackers = [None] * len(pool)
    cursor = {"slot": 0, "i": 0}

    def publish(frame: int) -> None:
        slot = cursor["slot"]
        if cursor["i"] == 0 and trackers[slot] is not None:
            trackers[slot].wait()  # backpressure: the slot is in flight
            trackers[slot] = None
        buf = pool[slot]
        scene.observation_into(frame, buf, cursor["i"])
        mark()
        cursor["i"] += 1
        if cursor["i"] == b:
            trackers[slot] = timed.publish_tracked(_batched=True, **buf)
            cursor["i"] = 0
            cursor["slot"] = (slot + 1) % len(pool)

    def flush() -> None:
        # the filled prefix of a partial batch (--frames not a multiple of
        # --batch); the consumer's ingest re-batches mismatched sizes
        i = cursor["i"]
        if i > 0:
            buf = pool[cursor["slot"]]
            timed.publish(_batched=True,
                          **{k: v[:i].copy() for k, v in buf.items()})

    return publish, flush


def main(argv=None) -> None:
    opts = parse_args(argv)
    native = not opts.no_native
    scene = CubeScene(shape=tuple(opts.shape), seed=opts.seed, native=native)
    if native:
        from blendjax_torch._native.build import paths

        libs = paths()
        _say(f"path native: C++ render, tile scan and palettizer "
             f"({libs['rasterizer']}, {libs['tiledelta']})", opts.log)
    else:
        _say("path numpy: numpy render, tile scan and palettizer", opts.log)
    send_hwm = 2
    pub = DataPublisherSocket(opts.bind, btid=opts.btid, lingerms=10000,
                              send_hwm=send_hwm,
                              trace_every=opts.trace_every,
                              **wire_kwargs(opts))
    if opts.addr_file:
        tmp = f"{opts.addr_file}.tmp"
        with open(tmp, "w") as f:
            f.write(pub.addr)
        os.replace(tmp, opts.addr_file)
    timed = _TimedPublisher(pub)
    clock = {"t0": 0.0, "t1": 0.0, "render_s": 0.0, "add_s": 0.0}

    def mark() -> None:
        clock["t1"] = time.perf_counter()

    fused = lambda: False  # noqa: E731
    if opts.encoding == "tile":
        add, flush, fused = _tile_publish(opts, scene, timed, native, mark)
    elif opts.encoding == "pal":
        add, flush = _pal_publish(opts, scene, timed, mark)
    else:
        add, flush = _raw_publish(opts, scene, timed, send_hwm, mark)
    ctrl = AnimationController(SimEngine(scene))

    def start_frame(frame: int) -> None:
        clock["t0"] = time.perf_counter()

    def publish(frame: int) -> None:
        # the engine stepped the scene (the controller's producer.frame
        # span): render, encode and publish the frame
        add(frame)
        t2 = time.perf_counter()
        clock["render_s"] += clock["t1"] - clock["t0"]  # step + render
        clock["add_s"] += t2 - clock["t1"]
        if frame % REPORT_EVERY == 0:
            render_s, add_s = clock["render_s"], clock["add_s"]
            encode_s = add_s - timed.seconds
            _say("stats " + json.dumps({
                "btid": opts.btid, "seed": opts.seed,
                "path": "native" if native else "numpy",
                "encoding": opts.encoding,
                "frames": frame,
                "render_ms": render_s / frame * 1e3,
                "encode_ms": encode_s / frame * 1e3,
                "publish_ms": timed.seconds / frame * 1e3,
                "own_frames_s": frame / (render_s + encode_s),
                "wire": opts.wire,
                "fused": fused(),
                "msg_bytes": timed.array_bytes / max(timed.messages, 1),
                "frames_per_msg": opts.batch,
                "shm_fallbacks": pub.shm_fallbacks,
                "shm_reclaims": pub.shm_reclaims,
            }), opts.log)
        if 0 < opts.frames <= frame:
            ctrl.cancel()

    ctrl.pre_frame.add(start_frame)
    ctrl.post_frame.add(publish)
    end = opts.frames if opts.frames > 0 else 2_147_483_647
    try:
        ctrl.play(frame_range=(1, end), num_episodes=-1)
        if flush is not None:
            flush()
    finally:
        pub.close()
        term_context()  # block until the tail is flushed (bounded by linger)


if __name__ == "__main__":
    main()
