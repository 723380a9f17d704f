"""The traffic: one general generator, driven by a mix's parameters.

A mix (``portbench/traffic/<name>.json``) is read by :func:`make_feed`:

- ``"source": "live"``: ``producers`` of the port's cube producer
  (``python -m blendjax_torch.producer.cube``, C++ render and tile scan),
  producer ``i`` rendering the cube scene ``scene_seeds[i]``, publishing
  tile-delta messages of ``batch`` frames on ``wire``; the port's ``StreamDataPipeline`` ingests
  them with ``ingest_workers`` and tees the first ``check_messages``
  received into a recording the reference reads;
- ``"source": "recording"``: ``messages`` messages of the same stream
  (the cube scene ``scene_seed``), rendered and encoded in set-up by the
  producer's own encoder, started at a position drawn from the run's seed,
  written to a ``.bjr`` file under the run's directory and replayed in a
  loop through ``StreamDataPipeline.from_recording``.

Both yield the packed chunk groups (``chunk`` batches) of the fused
step. For every message the feed keeps a record: producer, publish wall
time (live), receive wall time (live) and the changed-tile slots it
carries, which the frame-age metric and the K1 roofline read. A trained
batch's record is found by its producer (``_meta``'s ``btid``): each
producer's messages reach the step in the order they were received.
"""

from __future__ import annotations

import collections
import itertools
import os
import subprocess
import sys
import threading
import time

import numpy as np

from portbench.cell import ROOT

FIELD = "image"


def slot_record(msg: dict) -> dict:
    """What a tile-delta message carries for the K1 count: its frames,
    the index slots, the changed (non-sentinel) slots, the tile bytes,
    the reference tiles and the decoded bytes."""
    idx = msg.get(FIELD + "__tileidx")
    geom = msg.get(FIELD + "__tileshape")
    if idx is None or geom is None:
        return {}
    geom = [int(v) for v in geom]
    h, w, c = geom[:3]
    th, tw = (geom[3], geom[4]) if len(geom) >= 5 else (geom[3], geom[3])
    n = (h // th) * (w // tw)
    idx = np.asarray(idx)
    return {"frames": int(idx.shape[0]), "idx_numel": int(idx.size),
            "valid": int(np.count_nonzero(idx < n)), "ttc": th * tw * c,
            "n_tiles": n, "out_bytes": int(idx.shape[0]) * h * w * c}


class Records:
    """Per-producer FIFO of message records; ``take(btid)`` hands the next
    one to the batch that trained it."""

    def __init__(self, cycle: list | None = None):
        self._lock = threading.Lock()
        self._queues: dict = collections.defaultdict(collections.deque)
        self._cycle = cycle  # a looped recording's records, in order
        self._at = 0

    def add(self, rec: dict) -> None:
        with self._lock:
            self._queues[rec.get("btid")].append(rec)

    def take(self, btid) -> dict:
        if self._cycle is not None:
            rec = self._cycle[self._at % len(self._cycle)]
            self._at += 1
            return rec
        with self._lock:
            q = self._queues.get(btid)
            if not q:
                raise RuntimeError(f"a batch of producer {btid!r} with no "
                                   "received message left to match it")
            return q.popleft()


class LineageTap:
    """Reads each received message's publish stamps and slots just before
    the port's frame lineage pops them (``lineage.ingest``), into a
    :class:`Records`. :meth:`close` puts the lineage back."""

    def __init__(self, records: Records):
        from blendjax_torch.obs.lineage import lineage

        self.records = records
        self.lineage = lineage
        self.inner = lineage.ingest
        lineage.ingest = self._ingest

    def _ingest(self, msg: dict, track_gaps: bool = True):
        rec = {"btid": msg.get("btid"), "seq": msg.get("_seq"),
               "pub_wall": msg.get("_pub_wall"), "recv_wall": time.time(),
               **slot_record(msg)}
        self.records.add(rec)
        return self.inner(msg, track_gaps=track_gaps)

    def close(self) -> None:
        if self.lineage.__dict__.get("ingest") is not None:
            del self.lineage.ingest


def stream_messages(traffic: dict, seed: int):
    """Tile-delta messages of one cube producer seeded ``seed``, as its
    encoder makes them (the publish's ``btid`` added), without end."""
    from blendjax_torch.producer import CubeScene, TileBatchPublisher

    shape = tuple(traffic["shape"])
    out = []

    class Capture:
        def publish(self, **msg):
            out.append({"btid": 0, **msg})

    scene = CubeScene(shape=shape, seed=seed)
    tiles = TileBatchPublisher(
        Capture(), scene.background_image(), traffic["batch"],
        tile=tuple(traffic["tile"]), alpha_slice=False,
        ref_interval=traffic["ref_interval"],
        capacity=traffic["tile_capacity"])
    frame_buf = np.empty((*shape, 4), np.uint8)
    frame = 1
    while True:
        scene.step(frame)
        scene.render(out=frame_buf)
        tiles.add(frame_buf, hint=scene.raster.last_drawn,
                  xy=scene.camera.world_to_pixel(
                      scene.corners_world()).astype(np.float32),
                  frameid=np.int64(frame))
        frame += 1
        while out:
            yield out.pop(0)


def render_messages(traffic: dict, seed: int, count: int) -> list:
    """The first ``count`` messages of :func:`stream_messages`."""
    return list(itertools.islice(stream_messages(traffic, seed), count))


def plan_groups(traffic: dict, device) -> list:
    """Packed groups of every plan signature the stream makes: K' = 1 ..
    chunk groups of 2-bit and of 4-bit palette messages (a frame of 5-16
    colours; cube frames have not shown more). A live stream reaches all
    of them, some rarely, so set-up captures each before the window."""
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.ops.tiles import TILEPAL_SUFFIXES, TILEREF_SUFFIX

    chunk = traffic["chunk"]
    by_bits = {2: [], 4: []}
    ref = None
    for msg in itertools.islice(stream_messages(traffic, 0), 400):
        if ref is None:
            ref = msg[FIELD + TILEREF_SUFFIX]
        for bits in by_bits:
            if FIELD + TILEPAL_SUFFIXES[bits] in msg:
                by_bits[bits].append(msg)
        if min(len(v) for v in by_bits.values()) >= chunk:
            break
    groups = []
    for bits, found in by_bits.items():
        if len(found) < chunk:
            raise RuntimeError(f"{len(found)} messages of {bits}-bit "
                               f"palettes in 400: cannot prepare the plans")
        for k in range(1, chunk + 1):
            part = [dict(m) for m in found[:k]]
            part[0][FIELD + TILEREF_SUFFIX] = ref
            groups += list(StreamDataPipeline(
                iter(part), batch_size=traffic["batch"], chunk=k,
                emit_packed=True, device=device))
    return groups


class LiveFeed:
    """Producers on the port's cube stream, ingested live."""

    def __init__(self, traffic: dict, seed: int, workdir: str, device):
        from blendjax_torch.data import StreamDataPipeline

        self.traffic = traffic
        self.workdir = workdir
        self.records = Records()
        self.procs, self.logs = [], []
        self.pipeline = None
        self.tap = LineageTap(self.records)
        try:
            addrs = self._start(seed)
            self.record_prefix = os.path.join(workdir, "check")
            self.pipeline = StreamDataPipeline(
                addrs, batch_size=traffic["batch"], chunk=traffic["chunk"],
                emit_packed=True, timeoutms=60_000, device=device,
                ingest_workers=traffic["ingest_workers"],
                record_path_prefix=self.record_prefix,
                record_max_messages=traffic["check_messages"],
                on_timeout=self._on_timeout)
        except BaseException:
            self.stop()
            raise

    def _start(self, seed: int) -> list:
        t = self.traffic
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        addr_files = []
        for i in range(t["producers"]):
            addr = os.path.join(self.workdir, f"producer{i}.addr")
            log = os.path.join(self.workdir, f"producer{i}.log")
            cmd = [
                sys.executable, "-m", "blendjax_torch.producer.cube",
                "--addr-file", addr, "--log", log, "--btid", str(i),
                "--seed", str(t["scene_seeds"][i]),
                "--shape", *map(str, t["shape"]), "--batch", str(t["batch"]),
                "--encoding", "tile", "--tile", *map(str, t["tile"]),
                "--tile-rgba", "--tile-capacity", str(t["tile_capacity"]),
                "--ref-interval", str(t["ref_interval"]), "--wire", t["wire"],
            ]
            self.procs.append(subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
            self.logs.append(log)
            addr_files.append(addr)
        addrs = []
        deadline = time.monotonic() + 120
        for proc, path in zip(self.procs, addr_files):
            while not os.path.exists(path):
                if proc.poll() is not None:
                    raise RuntimeError(f"producer exited with "
                                       f"{proc.returncode} before binding")
                if time.monotonic() > deadline:
                    raise RuntimeError("producer did not bind in 120 s")
                time.sleep(0.02)
            with open(path) as f:
                addrs.append(f.read().strip())
        return addrs

    def _on_timeout(self) -> bool:
        dead = [p.returncode for p in self.procs if p.poll() is not None]
        if dead:
            raise RuntimeError(f"producers exited with {dead}")
        return False

    def check_messages(self) -> list:
        """The teed messages (raw frames, in receive order); read once
        the pipeline has stopped."""
        from portbench.reference.wire import read_recording

        return read_recording(f"{self.record_prefix}_00.bjr")

    def producer_stats(self) -> list:
        """Each producer's last stats line (its own frames/s: render and
        encode, the publish left out)."""
        import json

        out = []
        for log in self.logs:
            if not os.path.exists(log):
                continue
            with open(log) as f:
                lines = [ln.split(" stats ", 1)[1] for ln in f
                         if " stats " in ln]
            if lines:
                out.append(json.loads(lines[-1]))
        return out

    def stop(self) -> None:
        if self.pipeline is not None:
            self.pipeline.stop()
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.tap.close()


def rotated(msgs: list, seed: int) -> list:
    """The recording's messages from position ``seed % len(msgs)`` on, round
    to the start: every seed replays the same messages (the same tile
    counts and palette widths, so the same work) in another order. The
    first message carries the stream's reference frame."""
    at = int(seed) % len(msgs)
    out = [dict(m) for m in msgs[at:] + msgs[:at]]
    key = FIELD + "__tileref"
    ref = next(m[key] for m in msgs if key in m)
    out[0].setdefault(key, ref)
    return out


class RecordingFeed:
    """A recording rendered in set-up from the mix's scene and rotated by
    the seed (:func:`rotated`), replayed in a loop."""

    def __init__(self, traffic: dict, seed: int, workdir: str, device):
        from blendjax_torch.data import StreamDataPipeline
        from blendjax_torch.data.replay import FileRecorder
        from blendjax_torch.transport.wire import encode_message

        self.traffic = traffic
        msgs = rotated(render_messages(traffic, traffic["scene_seed"],
                                       traffic["messages"]), seed)
        self.path = os.path.join(workdir, "recording.bjr")
        with FileRecorder(self.path) as rec:
            for msg in msgs:
                rec.save(encode_message(msg))
        self.records = Records(cycle=[{"index": i, **slot_record(m)}
                                      for i, m in enumerate(msgs)])
        self.pipeline = StreamDataPipeline.from_recording(
            self.path, batch_size=traffic["batch"], chunk=traffic["chunk"],
            emit_packed=True, loop=True, device=device)

    def check_messages(self) -> list:
        from portbench.reference.wire import read_recording

        return read_recording(self.path, self.traffic["check_messages"])

    def producer_stats(self) -> list:
        return []

    def stop(self) -> None:
        self.pipeline.stop()


FEEDS = {"live": LiveFeed, "recording": RecordingFeed}


def make_feed(traffic: dict, seed: int, workdir: str, device):
    return FEEDS[traffic["source"]](traffic, seed, workdir, device)
