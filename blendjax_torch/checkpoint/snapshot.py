"""SnapshotManager: asynchronous snapshots off the step path (the port's
copy of ``blendjax/checkpoint/snapshot.py``, writing the same format).

Three stages, each on the thread that can afford it:

1. **enqueue** (the train loop's thread, at a step boundary): every
   tensor of the state and the session is cloned on the current CUDA
   stream, the stream the step's graph replays on, and one event is
   recorded after the clones. Nothing waits: the clones are queued behind
   the step that produced the state, and the next replay, which updates
   the live parameters and moments in place, is queued behind the clones.
   Without the clones the writer would read a state that later steps
   overwrite.
2. **write** (the manager's thread): waits for that event, copies each
   clone to the host, writes the array files, the session msgpack and the
   manifest into a ``.tmp-`` directory, then renames it into place.
   ``save_ms`` is measured here.
3. **retention**: the oldest committed snapshots beyond ``keep`` are
   removed after each commit; ``.tmp-`` stages left by a killed writer are
   swept at start.

At most one snapshot is being written and one is pending: a third
:meth:`save_async` before the writer catches up replaces the pending one
(``skipped``), so a slow disk lowers the snapshot rate instead of piling
up clones on the card.

Counters are attributes: ``saves``, ``restores``, ``resharded_restores``,
``skipped``, ``failed``, ``bytes``, ``save_ms`` (one entry per commit) and
``last_step``; the registry mirrors them as ``ckpt.*`` (the JAX package's
names: counters, the ``ckpt.save_ms`` histogram, the ``ckpt.last_step``
gauge).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import threading
import time

import torch

from blendjax_torch.checkpoint import format as fmt
from blendjax_torch.constants import LOGGER_NAME
from blendjax_torch.utils.metrics import metrics

logger = logging.getLogger(f"{LOGGER_NAME}.checkpoint")

_STEP_PREFIX = "step-"
_TMP_PREFIX = ".tmp-"


def committed_steps(directory: str) -> list:
    """Committed snapshot steps in ``directory``, ascending: a ``step-N``
    directory whose manifest landed. Read-only, so another process may
    poll it while a writer runs."""
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if not name.startswith(_STEP_PREFIX):
            continue
        tail = name[len(_STEP_PREFIX):]
        if tail.isdigit() and os.path.exists(
            os.path.join(directory, name, fmt.MANIFEST)
        ):
            out.append(int(tail))
    return sorted(out)


@dataclasses.dataclass
class Restored:
    """One restored snapshot: the state (path -> host array or scalar),
    the session dict (``{}`` when none was saved), the step it was taken
    at, and whether a leaf was saved in more than one shard."""

    step: int
    state: dict
    session: dict
    resharded: bool


def _clone_tensors(tree):
    """Clone every tensor of a state or session on its current stream;
    everything else passes by reference (the session codec copies host
    values on the writer thread)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tensors(v) for v in tree)
    return tree


def _cuda_devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


class SnapshotManager:
    """Asynchronous, pickle-free train-state and session snapshots.

    >>> mgr = SnapshotManager("ckpt/", keep=3)
    >>> mgr.save_async(step, train_state_leaves(state), session=...)
    >>> restored = mgr.restore(template)   # None when the directory is empty

    ``TrainDriver(checkpoint=mgr, checkpoint_every=N, session_state=...)``
    snapshots at step boundaries. A state is a mapping from leaf path to
    tensor, array or scalar (:mod:`blendjax_torch.checkpoint.format`).
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = max(1, int(keep))
        os.makedirs(self.directory, exist_ok=True)
        self._cv = threading.Condition()
        self._pending: tuple | None = None
        self._busy = False
        self._stop = False
        self._thread: threading.Thread | None = None
        #: The most recent write failure (``None`` after a success): the
        #: writer never raises into the train loop, so a caller that must
        #: know a flush landed reads this after :meth:`wait`.
        self.last_error: BaseException | None = None
        self.saves = 0
        self.restores = 0
        self.resharded_restores = 0
        self.skipped = 0
        self.failed = 0
        self.bytes = 0
        self.save_ms: list = []
        self.last_step: int | None = None
        self._sweep_stale()

    # -- lifecycle ------------------------------------------------------------

    def _sweep_stale(self) -> None:
        """Remove ``.tmp-`` stages a killed writer left; committed
        snapshots are untouched."""
        for name in os.listdir(self.directory):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
                logger.info("swept interrupted snapshot stage %s", name)

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer, name="blendjax-torch-ckpt-writer",
                daemon=True,
            )
            self._thread.start()

    # -- save -----------------------------------------------------------------

    def save_async(self, step: int, state: dict,
                   session: dict | None = None) -> None:
        """Snapshot ``state`` (and the host ``session``) as of now and
        return at once: the tensors are cloned on their current streams
        before this returns, so the caller may update its own in place
        right after; the copy to the host and the files are the writer's."""
        refs = _clone_tensors(dict(state))
        session_refs = _clone_tensors(session) if session else {}
        ready = []
        for dev in _cuda_devices((refs, session_refs), set()):
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            ready.append(event)
        with self._cv:
            if self._stop:
                raise RuntimeError("SnapshotManager is closed")
            if self._pending is not None:
                self.skipped += 1
                metrics.count("ckpt.skipped")
                logger.warning(
                    "snapshot writer behind: dropping queued step %d for "
                    "step %d", self._pending[0], step,
                )
            self._pending = (int(step), refs, session_refs, ready)
            self._ensure_thread()
            self._cv.notify_all()

    def save(self, step: int, state: dict,
             session: dict | None = None) -> None:
        """Enqueue and wait: the teardown and preemption path."""
        self.save_async(step, state, session=session)
        self.wait()

    def _writer(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._stop:
                    self._cv.wait()
                if self._pending is None and self._stop:
                    return
                item = self._pending
                self._pending = None
                self._busy = True
            try:
                self._write_one(*item)
                self.last_error = None
            except Exception as e:
                self.last_error = e
                self.failed += 1
                metrics.count("ckpt.failed")
                logger.exception("snapshot write failed (step %d)", item[0])
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _write_one(self, step: int, state: dict, session: dict,
                   ready: list) -> None:
        t0 = time.monotonic()
        for event in ready:
            event.synchronize()  # the clones are complete
        final = os.path.join(self.directory, f"{_STEP_PREFIX}{step:08d}")
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{step:08d}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        leaves, nbytes = fmt.write_state(tmp, state)
        session_name = None
        if session:
            raw = fmt.pack_session(session)
            session_name = fmt.SESSION_FILE
            with open(os.path.join(tmp, session_name), "wb") as f:
                f.write(raw)
            nbytes += len(raw)
        fmt.write_manifest(tmp, {
            "format": fmt.FORMAT_VERSION,
            "step": int(step),
            "wall_time": time.time(),
            "bytes": int(nbytes),
            "leaves": leaves,
            "session": session_name,
        })
        if os.path.exists(final):  # a re-save of the same step replaces it
            shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._prune()
        dt_ms = (time.monotonic() - t0) * 1e3
        self.saves += 1
        self.bytes += int(nbytes)
        self.save_ms.append(dt_ms)
        self.last_step = int(step)
        metrics.count("ckpt.saves")
        metrics.count("ckpt.bytes", int(nbytes))
        metrics.observe("ckpt.save_ms", dt_ms)
        metrics.gauge("ckpt.last_step", int(step))
        logger.info("snapshot committed: step %d (%.1f MB in %.0f ms)",
                    step, nbytes / 1e6, dt_ms)

    def _prune(self) -> None:
        steps = self.steps()
        for victim in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(
                os.path.join(self.directory, f"{_STEP_PREFIX}{victim:08d}"),
                ignore_errors=True,
            )

    def wait(self) -> None:
        """Block until no snapshot is pending or being written."""
        with self._cv:
            self._cv.wait_for(lambda: self._pending is None and not self._busy)

    def close(self) -> None:
        self.wait()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "SnapshotManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- inspection -----------------------------------------------------------

    def steps(self) -> list:
        """Committed snapshot steps, ascending."""
        return committed_steps(self.directory)

    def latest_step(self, wait: bool = True):
        """The newest committed step (``None`` when there is none);
        ``wait=True`` lets a write in flight land first."""
        if wait:
            self.wait()
        steps = self.steps()
        return steps[-1] if steps else None

    # -- restore --------------------------------------------------------------

    def restore(self, template=None, step: int | None = None
                ) -> Restored | None:
        """The newest (or ``step``'s) committed snapshot, read for the
        paths of ``template`` (every saved path when ``None``); ``None``
        when no snapshot exists. The state comes back as host arrays: the
        caller copies them into its tensors
        (:func:`blendjax_torch.weights.load_train_state_leaves`)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        directory = os.path.join(self.directory,
                                 f"{_STEP_PREFIX}{int(step):08d}")
        manifest = fmt.read_manifest(directory)
        state, resharded = fmt.read_state(directory, manifest["leaves"],
                                          template)
        session: dict = {}
        if manifest.get("session"):
            with open(os.path.join(directory, manifest["session"]), "rb") as f:
                session = fmt.unpack_session(f.read())
        self.restores += 1
        metrics.count("ckpt.restores")
        if resharded:
            self.resharded_restores += 1
            metrics.count("ckpt.resharded_restores")
        return Restored(step=int(manifest["step"]), state=state,
                        session=session, resharded=bool(resharded))


__all__ = ["Restored", "SnapshotManager", "committed_steps"]
