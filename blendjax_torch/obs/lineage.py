"""Frame lineage: publish stamps → per-producer staleness and gap counts
(copied from ``blendjax/obs/lineage.py``; :meth:`FrameLineage.ingest`
also returns the message's sequence verdict, which
:class:`~blendjax_torch.data.stream.RemoteStream` sums into its own
``seq_gaps``, ``reorders`` and ``restarts``).

Dapper-style cross-process latency attribution for the data stream:
``DataPublisherSocket`` stamps every message with a wall + monotonic
publish time and a per-producer monotonic sequence number (and
periodically piggybacks a telemetry snapshot of the producer's own
metrics registry — see :mod:`blendjax_torch.transport.channels`); the
consumer-side receive loop hands each decoded message to
:meth:`FrameLineage.ingest`, which turns the stamps into:

- a per-producer **end-to-end staleness histogram** (consumer receive
  wall time minus producer publish wall time — how old a frame already
  is when it reaches ingest; the wire/producer discriminator the stall
  doctor uses),
- **seq-gap / reorder counters** (``wire.seq_gaps`` counts *dropped*
  messages exactly: the PUSH/PULL data plane is at-most-once by design,
  so a nonzero gap count on a clean local run is a bug, which is why
  ``chip_smoke.py`` asserts it stays 0),
- a **fleet telemetry view**: the latest piggybacked producer snapshot
  per producer, aggregated without a second socket.

Sequence tracking is PER PRODUCER (keyed by ``btid``), so the sharded
ingest pool's round-robin partitioning — which interleaves producers
across shards arbitrarily — never manufactures false gaps: each
producer's stream lands whole on exactly one shard socket, and a gap is
only counted when that producer's own numbering skips.

Cardinality note: per-producer state lives in this tracker's own dict
(bounded by the real fleet size), NOT as dynamic metric-registry names —
the shape bjx-lint BJX107 exists to enforce.
"""

from __future__ import annotations

# bjx: hot-path (ingest() runs once per received message: BJX102 flags
# any blocking device sync added to this module)

import threading
import time

# The sampled frame-trace context is a publish stamp too: strip_stamps
# removes it on replay — recorded wall stamps would read as hours of
# wire latency in the trace histograms. Imported from its defining
# module so a rename can never desynchronize the strip list.
from blendjax_torch.obs.trace import TRACE_KEY
from blendjax_torch.utils.metrics import Histogram, metrics

# Wire keys (stamped by DataPublisherSocket, popped here). Underscored
# like the other wire-control keys (`_batched`, `_prebatched`) so they
# can never collide with a user field.
SEQ_KEY = "_seq"
PUB_WALL_KEY = "_pub_wall"
PUB_MONO_KEY = "_pub_mono"
TELEMETRY_KEY = "_telemetry"

# Deliberately NOT a stamp: "_scenario" (the scenario service). Lineage
# stamps describe the TRANSPORT of a frame (when/in what order it was
# published) and go stale on replay; the scenario stamp describes the
# CONTENT (which distribution rendered it) and must survive replay so
# recorded streams re-account per scenario deterministically.
_STAMP_KEYS = (SEQ_KEY, PUB_WALL_KEY, PUB_MONO_KEY, TELEMETRY_KEY,
               TRACE_KEY)


def strip_stamps(msg: dict) -> dict:
    """Remove lineage/telemetry stamps without accounting them — the
    replay path (recorded wall times would read as hours of staleness)
    and any consumer that wants the unstamped message shape back."""
    for k in _STAMP_KEYS:
        msg.pop(k, None)
    return msg


class _Producer:
    """Per-producer lineage state (guarded by the tracker's lock)."""

    __slots__ = (
        "received", "last_seq", "gaps", "reorders", "restarts",
        "staleness", "telemetry", "telemetry_at", "last_pub_wall",
        "last_pub_mono",
    )

    def __init__(self) -> None:
        self.received = 0
        self.last_seq: int | None = None
        self.gaps = 0
        self.reorders = 0
        self.restarts = 0
        self.staleness = Histogram()  # seconds
        self.telemetry: dict | None = None
        self.telemetry_at: float | None = None
        self.last_pub_wall: float | None = None
        self.last_pub_mono: float | None = None


class FrameLineage:
    """Consumer-side lineage aggregator (one per process, like the
    metrics registry; thread-safe for the sharded ingest pool)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._producers: dict = {}

    def ingest(self, msg: dict, track_gaps: bool = True) -> tuple:
        """Pop the publish stamps off one decoded message and account
        them. Messages without stamps (unstamping producers, reference
        pickle producers) pass through untouched — lineage is additive,
        not a wire-compat break.

        ``track_gaps=False`` skips the sequence bookkeeping (gaps,
        reorders, restarts) while keeping staleness and telemetry: the
        mode for consumers that share a producer fan-in with peers
        (each sees a strided subsequence — see
        :class:`blendjax_torch.data.stream.RemoteStream`).

        Returns ``(gap, reordered, restarted)``: the messages this one's
        sequence number says were dropped, and whether it arrived late or
        opened a restart (``(0, False, False)`` for an unstamped or
        untracked message)."""
        seq = msg.pop(SEQ_KEY, None)
        wall = msg.pop(PUB_WALL_KEY, None)
        mono = msg.pop(PUB_MONO_KEY, None)
        tele = msg.pop(TELEMETRY_KEY, None)
        if seq is None and wall is None and tele is None:
            return 0, False, False
        now = time.time()
        btid = msg.get("btid")
        stale = None
        gap = 0
        reordered = restarted = False
        with self._lock:
            # get-then-insert, not setdefault: setdefault would allocate
            # a throwaway _Producer (+ Histogram) on EVERY message for a
            # dict hit that succeeds ~always — churn on the per-frame
            # hot path.
            p = self._producers.get(btid)
            if p is None:
                p = self._producers[btid] = _Producer()
            p.received += 1
            if wall is not None:
                stale = now - float(wall)
                p.staleness.observe(stale)
                p.last_pub_wall = float(wall)
            if mono is not None:
                p.last_pub_mono = float(mono)
            if seq is not None and track_gaps:
                seq = int(seq)
                if p.last_seq is None:
                    p.last_seq = seq
                else:
                    expected = p.last_seq + 1
                    if seq > expected:
                        gap = seq - expected
                        p.gaps += gap
                        p.last_seq = seq
                    elif seq == expected:
                        p.last_seq = seq
                    elif seq == 0:
                        # A fresh publisher numbers from 0: this is a
                        # producer RESTART (launcher respawn reuses the
                        # btid), not a reorder. Without the reset, every
                        # post-respawn message would read as a reorder
                        # until seq caught the dead instance's maximum —
                        # and real drops in that window would be
                        # invisible.
                        restarted = True
                        p.restarts += 1
                        p.last_seq = 0
                    else:
                        # late delivery of an older number: a reorder,
                        # not a drop (and not a negative gap). last_seq
                        # keeps the high-water mark.
                        reordered = True
                        p.reorders += 1
            if tele is not None:
                p.telemetry = tele
                p.telemetry_at = now
        # Registry mirrors OUTSIDE the lineage lock (constant names —
        # the fleet-wide aggregates beside the per-producer detail).
        if stale is not None:
            metrics.observe("wire.e2e_staleness_s", stale)
        if gap:
            metrics.count("wire.seq_gaps", gap)
        if reordered:
            metrics.count("wire.seq_reorders")
        if restarted:
            metrics.count("wire.producer_restarts")
        return gap, reordered, restarted

    # -- snapshots ------------------------------------------------------------

    def report(self) -> dict:
        """Per-producer lineage snapshot, keyed by ``str(btid)``:
        staleness summary (ms percentiles), exact gap/reorder counts,
        and the latest piggybacked telemetry."""
        with self._lock:
            out = {}
            for btid, p in self._producers.items():
                s = p.staleness.summary()
                entry = {
                    "received": p.received,
                    "last_seq": p.last_seq,
                    "seq_gaps": p.gaps,
                    "seq_reorders": p.reorders,
                    "restarts": p.restarts,
                    "e2e_staleness_ms": {
                        "count": s["count"],
                        "p50": round(s["p50"] * 1e3, 3),
                        "p95": round(s["p95"] * 1e3, 3),
                        "p99": round(s["p99"] * 1e3, 3),
                        "max": round(s["max"] * 1e3, 3) if s["count"] else 0.0,
                    },
                }
                if p.telemetry is not None:
                    entry["telemetry"] = p.telemetry
                    entry["telemetry_age_s"] = round(
                        time.time() - (p.telemetry_at or 0.0), 3
                    )
                out[str(btid)] = entry
            return out

    def staleness_p95_s(self) -> float | None:
        """Worst per-producer staleness p95 in seconds (None when no
        stamped frames were seen) — the doctor's wire/producer
        discriminator."""
        with self._lock:
            vals = [
                p.staleness.quantile(0.95)
                for p in self._producers.values()
                if p.staleness.count
            ]
        return max(vals) if vals else None

    def total_gaps(self) -> int:
        with self._lock:
            return sum(p.gaps for p in self._producers.values())

    # -- elastic membership ---------------------------------------------------

    def register(self, btid) -> None:
        """Pre-register a producer (fleet admission): its entry exists
        before the first frame, so the fleet view shows a joining
        member immediately. ``ingest`` would create it lazily anyway —
        a brand-new btid starts tracking at its first observed seq, so
        joining mid-run can never read as a drop storm."""
        with self._lock:
            if btid not in self._producers:
                self._producers[btid] = _Producer()

    def retire(self, btid) -> bool:
        """Drop a producer's lineage state on clean retirement (fleet
        scale-down). Without this a retired slot's stale seq state
        would (a) keep a dead member in every ``report()`` forever and
        (b) — if the btid is ever reused by a NEW producer numbering
        from its own 0 — count the rejoin as a restart plus reorder
        noise instead of fresh tracking. Returns True when state
        existed. NOT for crashes: a respawned producer reuses its slot
        and the seq==0 restart detection is the correct accounting
        there."""
        with self._lock:
            return self._producers.pop(btid, None) is not None

    def reset(self) -> None:
        with self._lock:
            self._producers.clear()

    # -- session snapshot (blendjax_torch.checkpoint) -------------------------

    def state_dict(self) -> dict:
        """Per-producer seq positions + exact counters for the session
        store. Staleness histograms are deliberately dropped: they
        describe the dead process's transport window, and stale
        percentiles would poison the resumed doctor's wire/producer
        discrimination. Keys keep their native type (btids are ints on
        the wire; msgpack carries them)."""
        with self._lock:
            return {
                btid: {
                    "received": p.received,
                    "last_seq": p.last_seq,
                    "gaps": p.gaps,
                    "reorders": p.reorders,
                    "restarts": p.restarts,
                }
                for btid, p in self._producers.items()
            }

    def load_state_dict(self, d: dict) -> None:
        """Restore seq positions so cross-restart accounting stays
        exact: a producer that kept publishing while the consumer was
        down resumes gap tracking from its last counted seq, and a
        producer that restarted alongside the consumer (fresh
        numbering from 0) is detected as a RESTART by the existing
        seq==0 arm — never as a gap storm."""
        with self._lock:
            for btid, e in d.items():
                p = self._producers.get(btid)
                if p is None:
                    p = self._producers[btid] = _Producer()
                p.received = int(e.get("received", 0))
                seq = e.get("last_seq")
                p.last_seq = int(seq) if seq is not None else None
                p.gaps = int(e.get("gaps", 0))
                p.reorders = int(e.get("reorders", 0))
                p.restarts = int(e.get("restarts", 0))


# Default process-wide tracker (mirrors ``blendjax_torch.utils.metrics.metrics``).
lineage = FrameLineage()
