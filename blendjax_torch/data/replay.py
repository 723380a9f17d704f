"""Record/replay of data streams (the port's copy of
``blendjax/data/replay.py``: the same ``.bjr`` container, so either
package replays the other's recordings).

Reference: ``pkg_pytorch/blendtorch/btt/file.py`` (``FileRecorder`` writes
raw pickled messages behind a pre-allocated offset header rewritten on
close, ``file.py:56-74``; ``FileReader`` loads the offset table and lazily
opens per worker, ``file.py:102-132``) and the replay datasets in
``dataset.py:119-153``.

blendjax's container (``.bjr``) stores the *wire frames* verbatim — the
same zero-copy multipart messages that crossed the socket — with an offset
index appended as a footer, so recording is a pure append-only tee (no
header rewrite, crash leaves a recoverable prefix) and replay decodes
through the identical ``decode_message`` path as live ingest. Not pickle:
recordings made from tensor-codec producers are safe to share
(``allow_pickle=False`` replays them fully).

Layout::

    b"BJXR1\\n"                                  magic
    repeat per message:
        u32 nframes, then per frame: u64 size + bytes
    footer: u64 offsets[n] ... u64 n, u64 footer_start, b"BJXRIDX"
"""

from __future__ import annotations

import glob as globmod
import os
import re
import struct

from blendjax_torch.transport.wire import decode_message

MAGIC = b"BJXR1\n"
FOOTER_MAGIC = b"BJXRIDX"


class FileRecorder:
    """Append-only recorder of raw wire frames.

    Reference API kept: ``FileRecorder(outpath, max_messages)`` as a
    context manager with ``save(...)`` per message (``file.py:10-79``);
    ``filename(prefix, worker_index)`` builds per-worker paths.
    """

    def __init__(self, outpath: str = "blendjax.bjr", max_messages: int | None = None):
        self.outpath = outpath
        self.max_messages = max_messages
        self.num_messages = 0
        self._offsets: list[int] = []
        self._file = None

    @staticmethod
    def filename(prefix: str, worker_index: int) -> str:
        """``{prefix}_{worker:02d}.bjr`` (reference ``file.py:76-79``)."""
        return f"{prefix}_{worker_index:02d}.bjr"

    def __enter__(self):
        os.makedirs(os.path.dirname(os.path.abspath(self.outpath)), exist_ok=True)
        self._file = open(self.outpath, "wb")
        self._file.write(MAGIC)
        return self

    def save(self, frames) -> bool:
        """Record one message's raw frames; returns False once full."""
        if self.max_messages is not None and self.num_messages >= self.max_messages:
            return False
        self._offsets.append(self._file.tell())
        self._file.write(struct.pack("<I", len(frames)))
        for f in frames:
            b = bytes(f)
            self._file.write(struct.pack("<Q", len(b)))
            self._file.write(b)
        self.num_messages += 1
        return True

    def __exit__(self, *exc):
        footer_start = self._file.tell()
        for off in self._offsets:
            self._file.write(struct.pack("<Q", off))
        self._file.write(struct.pack("<Q", len(self._offsets)))
        self._file.write(struct.pack("<Q", footer_start))
        self._file.write(FOOTER_MAGIC)
        self._file.close()
        self._file = None


def _load_index(path: str) -> list[int]:
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a blendjax recording")
        f.seek(-(len(FOOTER_MAGIC) + 16), os.SEEK_END)
        tail = f.read()
        if tail[16:] != FOOTER_MAGIC:
            raise ValueError(
                f"{path}: missing index footer (truncated recording? "
                "use FileReader.recover to scan)"
            )
        n, footer_start = struct.unpack("<QQ", tail[:16])
        f.seek(footer_start)
        return list(struct.unpack(f"<{n}Q", f.read(8 * n)))


class FileReader:
    """Random-access reader over a recording.

    Lazily opens the file handle on first read so instances can be shipped
    to worker processes (the reference reopens per worker for
    multiprocessing compatibility, ``file.py:102-108``).

    ``allow_pickle`` defaults to ``False``: native ``.bjr`` recordings
    are tensor-codec (pickle-free) and replay fully without it. Pass
    ``allow_pickle=True`` only for recordings teed from trusted legacy
    producers whose frames embed pickle (``PickleCodec`` wire frames or
    ``pkl`` fallback entries) — unpickling is code execution.
    """

    def __init__(self, path: str, allow_pickle: bool = False):
        self.path = path
        self.allow_pickle = allow_pickle
        self._offsets = _load_index(path)
        self._file = None
        self._pid = None

    @staticmethod
    def recover(path: str) -> list[int]:
        """Scan a footer-less (crashed) recording and return the offsets of
        complete messages."""
        offsets = []
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path}: not a blendjax recording")
            pos = f.tell()
            while pos + 4 <= size:
                f.seek(pos)
                (nframes,) = struct.unpack("<I", f.read(4))
                p = pos + 4
                ok = 0 < nframes < 1024
                for _ in range(nframes if ok else 0):
                    if p + 8 > size:
                        ok = False
                        break
                    f.seek(p)
                    (ln,) = struct.unpack("<Q", f.read(8))
                    p += 8 + ln
                    if p > size:
                        ok = False
                        break
                if not ok:
                    break
                offsets.append(pos)
                pos = p
        return offsets

    def __len__(self) -> int:
        return len(self._offsets)

    def _handle(self):
        if self._file is None or self._pid != os.getpid():
            self._file = open(self.path, "rb")
            self._pid = os.getpid()
        return self._file

    def frames(self, idx: int) -> list[bytes]:
        f = self._handle()
        f.seek(self._offsets[idx])
        (nframes,) = struct.unpack("<I", f.read(4))
        out = []
        for _ in range(nframes):
            (ln,) = struct.unpack("<Q", f.read(8))
            out.append(f.read(ln))
        return out

    def __getitem__(self, idx: int) -> dict:
        return decode_message(
            self.frames(idx), copy_arrays=True, allow_pickle=self.allow_pickle
        )

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class LegacyBtrReader:
    """Read the reference blendtorch's ``.btr`` recordings so a migrating
    user's existing data replays through the pipeline.

    Format (reference ``file.py:56-132``): ONE pickle stream per file —
    a pre-allocated int64 offset header (rewritten on close, ``-1`` marks
    unused slots) followed by the pickled message dicts, all written by a
    single ``Pickler``. That single pickler MEMOIZES across documents
    (repeated dict keys etc. become memo refs into earlier messages), so
    a fresh unpickler seeking straight to message ``k`` can hit
    ``Memo value not found``; the reference only ever reads forward
    through one ``Unpickler``. This reader keeps that unpickler but
    makes random access safe by warming the memo sequentially up to the
    highest index requested.

    Pickle-gated: the format IS pickle, so the trust decision cannot be
    implicit — ``allow_pickle`` defaults to ``False`` and constructing
    without an explicit ``allow_pickle=True`` raises. Recordings from
    untrusted sources should be re-recorded to ``.bjr`` (tensor codec,
    pickle-free).
    """

    def __init__(self, path: str, allow_pickle: bool = False):
        if not allow_pickle:
            raise ValueError(
                f"{path}: legacy .btr recordings are pickle streams; "
                "pass allow_pickle=True (trusted source) or convert to "
                ".bjr"
            )
        self.path = path
        self._file = None
        self._pid = None
        f, unpickler = self._open()
        try:
            self._offsets = self._header(unpickler)
        finally:
            f.close()

    @staticmethod
    def _header(unpickler):
        import numpy as np

        offsets = np.asarray(unpickler.load())
        unused = np.flatnonzero(offsets == -1)
        n = int(unused[0]) if len(unused) else len(offsets)
        return [int(o) for o in offsets[:n]]

    def _open(self):
        import io
        import pickle

        # buffering=0 is load-bearing (and what the reference uses,
        # ``file.py:104``): the C unpickler's read-ahead over a BUFFERED
        # file ignores seeks between load() calls and silently decodes
        # the wrong message.
        f = io.open(self.path, "rb", buffering=0)
        return f, pickle.Unpickler(f)

    def _handle(self):
        if self._file is None or self._pid != os.getpid():
            # Reopen per process (torch-worker compat, reference
            # ``file.py:102-108``); the header load primes the memo the
            # same way the writer's single pickler built it.
            self._file, self._unpickler = self._open()
            self._header(self._unpickler)
            self._pid = os.getpid()
            self._warm = 0
        return self._file

    def __len__(self) -> int:
        return len(self._offsets)

    def _load_at(self, idx: int):
        f = self._handle()
        f.seek(self._offsets[idx])
        return self._unpickler.load()

    def __getitem__(self, idx: int) -> dict:
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        self._handle()
        if idx >= self._warm:
            # Populate memo entries messages [warm, idx) contributed —
            # required before any later message's memo refs resolve.
            # _warm advances only per successful load: a truncated tail
            # message re-raises its own error on every retry instead of
            # leaving later reads to fail with 'Memo value not found'.
            for j in range(self._warm, idx):
                self._load_at(j)
                self._warm = j + 1
            obj = self._load_at(idx)
            self._warm = idx + 1
            return obj
        return self._load_at(idx)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


def open_reader(path: str, allow_pickle: bool = False):
    """Reader for one recording: ``.bjr`` (blendjax wire container) or a
    reference ``.btr`` (legacy pickle, see :class:`LegacyBtrReader`).

    Untrusted-safe by default: ``allow_pickle=False`` replays native
    tensor-codec ``.bjr`` files fully and refuses pickle everywhere
    (``.btr`` construction raises). Opt in per call site for trusted
    legacy recordings."""
    if str(path).endswith(".btr"):
        return LegacyBtrReader(path, allow_pickle=allow_pickle)
    return FileReader(path, allow_pickle=allow_pickle)


def _glob_recordings(prefix: str) -> list[str]:
    """Per-worker recordings for a prefix, either container format."""
    return sorted(
        globmod.glob(f"{prefix}_*.bjr") + globmod.glob(f"{prefix}_*.btr")
    )


def rank_prefix(prefix: str, rank: int, world: int) -> str:
    """The recording prefix of rank ``rank`` of a mesh of ``world`` data
    ranks: ``{prefix}.rank{rank}-of-{world}``, so each rank's stream writes
    files of its own (``{prefix}.rank0-of-2_00.bjr``, ...), which the
    one-card glob ``{prefix}_*.bjr`` does not match."""
    return f"{prefix}.rank{int(rank)}-of-{int(world)}"


_RANK_TAG = re.compile(r"\.rank(\d+)-of-(\d+)_\d+\.(?:bjr|btr)$")


def recorded_world(prefix: str) -> int | None:
    """The number of data ranks whose rank-tagged recordings
    (:func:`rank_prefix`) sit under ``prefix``; ``None`` when there are
    none (a one-card recording, a path). Raises when the files name more
    than one world size, or miss a rank."""
    found: dict = {}
    for path in globmod.glob(f"{globmod.escape(prefix)}.rank*-of-*_*.*"):
        m = _RANK_TAG.search(path)
        if m is not None:
            found.setdefault(int(m.group(2)), set()).add(int(m.group(1)))
    if not found:
        return None
    if len(found) > 1:
        raise ValueError(
            f"recordings under {prefix} were made at several world sizes "
            f"{sorted(found)}")
    (world, ranks), = found.items()
    if ranks != set(range(world)):
        raise ValueError(
            f"recordings under {prefix} were made by {world} ranks but hold "
            f"ranks {sorted(ranks)} only")
    return world


class ReplayStream:
    """Iterate recorded messages as a live-stream stand-in.

    A drop-in for ``RemoteStream`` as a :class:`StreamDataPipeline`
    source (``StreamDataPipeline.from_recording``): yields decoded
    message dicts in recorded order, so producer-batched and tile-delta
    messages flow through the identical ingest -> decode path as live
    traffic — a recorded sparse stream replays to bit-exact device
    frames with no producers running.

    ``source`` may be one recording path (``.bjr``, or a reference
    ``.btr`` — legacy pickle recordings replay through the same
    pipeline, behind an explicit ``allow_pickle=True``), a list of
    paths, or a recording prefix (globs ``{prefix}_*.bjr`` +
    ``{prefix}_*.btr`` like :class:`FileDataset`).
    """

    def __init__(self, source, allow_pickle: bool = False, loop: bool = False):
        if isinstance(source, str):
            if os.path.exists(source):
                paths = [source]
            else:
                paths = _glob_recordings(source)
                if not paths:
                    raise FileNotFoundError(
                        f"no recording at {source} or {source}_*.bjr/.btr"
                    )
        else:
            paths = list(source)
        self.readers = [
            open_reader(p, allow_pickle=allow_pickle) for p in paths
        ]
        self.loop = loop

    def __iter__(self):
        # Lineage stamps recorded off a live wire are STRIPPED, not
        # accounted: replayed wall times would read as hours of
        # staleness, and a looped replay would re-walk the same seq
        # numbers as an endless reorder storm.
        from blendjax_torch.obs.lineage import strip_stamps

        while True:
            for reader in self.readers:
                for i in range(len(reader)):
                    yield strip_stamps(reader[i])
            if not self.loop:
                return

    def close(self):
        for r in self.readers:
            r.close()


class SingleFileDataset:
    """Map-style dataset over one recording (reference ``dataset.py:119-132``)."""

    def __init__(self, path: str, item_transform=None,
                 allow_pickle: bool = False):
        self.reader = open_reader(path, allow_pickle=allow_pickle)
        self.item_transform = item_transform or (lambda x: x)

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, idx):
        # Same contract as ReplayStream: recorded lineage stamps are
        # stripped, not replayed — a map-style epoch would otherwise
        # collate `_seq`/`_pub_wall` sidecars straight into the train
        # batch (the BJX120 bug class).
        from blendjax_torch.obs.lineage import strip_stamps

        return self.item_transform(strip_stamps(self.reader[idx]))


class FileDataset:
    """Concatenation of ``{prefix}_*.bjr`` recordings (reference glob +
    concat, ``dataset.py:134-153``) — replay a multi-worker recording with
    no producers running."""

    def __init__(self, record_path_prefix: str, item_transform=None,
                 allow_pickle: bool = False):
        paths = _glob_recordings(record_path_prefix)
        if not paths:
            raise FileNotFoundError(
                f"no recordings matching {record_path_prefix}_*.bjr/.btr"
            )
        self.readers = [
            open_reader(p, allow_pickle=allow_pickle) for p in paths
        ]
        self._cum = []
        total = 0
        for r in self.readers:
            total += len(r)
            self._cum.append(total)
        self.item_transform = item_transform or (lambda x: x)

    def __len__(self):
        return self._cum[-1] if self._cum else 0

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        import bisect

        ri = bisect.bisect_right(self._cum, idx)
        base = self._cum[ri - 1] if ri else 0
        # Stamps stripped for the same reason as ReplayStream /
        # SingleFileDataset: replayed lineage is stale by construction.
        from blendjax_torch.obs.lineage import strip_stamps

        return self.item_transform(strip_stamps(self.readers[ri][idx - base]))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
