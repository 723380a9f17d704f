"""Exact per-scenario accounting: counts, fresh/echoed splits, losses
(copied from ``blendjax/scenario/accounting.py``: the same names, report
and snapshot shapes, so either package's ledger reads the other's).

Every train row is attributed to the scenario (and space version) that
produced it, with the echo counters' exactness: ``fresh + echoed == rows
drawn``, per scenario. Scenario ids are keys of this ledger's own bounded
structures, never parts of metric names: the registry sees only
``scenario.rows``, ``scenario.fresh``, ``scenario.echoed``,
``scenario.unstamped_rows`` and ``scenario.overflow_rows``; per-scenario
detail rides :meth:`ScenarioAccounting.report`. Ids outside every declared
space count up to ``max_scenarios`` distinct values, then fold into one
overflow bucket.

Wire shape: producers stamp ``_scenario = {"id": name, "ver": version,
"theta": [floats]}`` on each message; ingest carries it per row in
``_meta`` (``_scenario`` is a default meta key of
:class:`~blendjax_torch.data.schema.StreamSchema`); the echo reservoir keeps
a per-slot sidecar so echoed rows are attributed to the scenario of the
row that filled their slot.
"""

from __future__ import annotations

import collections
import threading

from blendjax_torch.utils.metrics import Histogram, metrics

#: Batch/message-level stamp key (a dict: {"id", "ver", "theta"}).
SCENARIO_KEY = "_scenario"
#: Per-row sidecar the echo pipeline attaches to drawn batches: a list
#: of per-row stamp dicts (or None for unstamped rows), host-side only.
SCENARIO_ROWS_KEY = "_scenario_rows"

#: Single buckets for rows that can't be attributed to a declared id.
OVERFLOW_ID = "__overflow__"


def batch_row_scenarios(batch: dict, lead: int):
    """Per-row scenario stamps of one batch: a list of ``lead`` stamp
    dicts (or ``None`` entries), or ``None`` when the batch carries no
    scenario stamps at all.

    Sources, in precedence order: an explicit per-row sidecar
    (``_scenario_rows``), per-item ``_meta`` entries (the assembled-
    batch path), or one batch-level ``_scenario`` stamp replicated to
    every row (the prebatched/passthrough path)."""
    rows = batch.get(SCENARIO_ROWS_KEY)
    if rows is not None:
        return list(rows)
    meta = batch.get("_meta")
    if isinstance(meta, list) and meta:
        out = None
        if any(isinstance(m, dict) and SCENARIO_KEY in m for m in meta):
            out = [
                m.get(SCENARIO_KEY) if isinstance(m, dict) else None
                for m in meta
            ]
        else:
            out = _flatten_chunk_meta(meta)
        if out is not None:
            # _meta's length is authoritative for assembled batches; pad
            # defensively if a caller passed a foreign lead
            if len(out) < lead:
                out.extend([None] * (lead - len(out)))
            return out[:lead]
    stamp = batch.get(SCENARIO_KEY)
    if isinstance(stamp, dict):
        return [stamp] * lead
    return None


def _flatten_chunk_meta(meta):
    """Chunked (K, B, ...) superbatches carry ``_meta`` as a list of K
    per-sub-batch REST dicts, each nesting that sub-batch's per-item
    ``_meta`` list (and, for prebatched producers, possibly a
    sub-batch-level ``_scenario`` stamp). Flatten to per-row stamps so
    a tile/chunk pipeline's scenario accounting doesn't silently read
    zero. Returns None when no stamp exists anywhere."""
    flat: list = []
    found = False
    for rest in meta:
        if not isinstance(rest, dict):
            return None  # not the chunk-rests shape
        sub = rest.get("_meta")
        sub_stamp = rest.get(SCENARIO_KEY)
        if isinstance(sub, list) and sub:
            for m in sub:
                s = m.get(SCENARIO_KEY) if isinstance(m, dict) else None
                if s is None:
                    s = sub_stamp if isinstance(sub_stamp, dict) else None
                flat.append(s)
                found = found or s is not None
        elif isinstance(sub_stamp, dict):
            # sub-batch-level stamp with no per-item meta: row count
            # unknown from here — one entry per sub-batch is the best
            # honest attribution (callers with exactness needs carry
            # per-item meta)
            flat.append(sub_stamp)
            found = True
        else:
            return None
    return flat if found else None


def _stamp_parts(stamp):
    """``(sid, ver, theta)`` of one stamp dict (tolerant of partial
    stamps from foreign producers)."""
    if not isinstance(stamp, dict):
        return None, None, None
    sid = stamp.get("id")
    ver = stamp.get("ver")
    theta = stamp.get("theta")
    return (
        str(sid) if sid is not None else None,
        int(ver) if ver is not None else None,
        theta,
    )


class _ScenarioStats:
    """Per-scenario ledger entry (guarded by the tracker's lock)."""

    __slots__ = (
        "rows", "fresh", "echoed", "loss", "win_loss_sum", "win_rows",
        "theta", "versions",
    )

    def __init__(self) -> None:
        self.rows = 0
        self.fresh = 0
        self.echoed = 0
        self.loss = Histogram()  # one observe per scored row
        # curriculum window: consumed (and zeroed) by window_losses()
        self.win_loss_sum = 0.0
        self.win_rows = 0
        # (theta, loss) pairs for the score-function update, bounded
        self.theta: collections.deque = collections.deque(maxlen=256)
        self.versions: dict = {}  # space version -> rows


class ScenarioAccounting:
    """Process-wide scenario ledger (one per process, like the metrics
    registry and frame lineage; thread-safe — the echo draw loop and a
    train loop may both account)."""

    def __init__(self, max_scenarios: int = 256):
        self._lock = threading.Lock()
        self._sc: dict = {}
        self._declared: set = set()
        self.max_scenarios = int(max_scenarios)
        self.space_version = 0

    # -- declaration ---------------------------------------------------------

    def declare(self, space) -> None:
        """Register a space's scenario names (the bounded key set) and
        its version. The service calls this on every publish; direct
        users may call it once up front. Ids outside every declared
        space still count (up to ``max_scenarios`` distinct), but are
        reported as undeclared."""
        with self._lock:
            for name in space.names:
                self._declared.add(str(name))
                if str(name) not in self._sc:
                    self._sc[str(name)] = _ScenarioStats()
            self.space_version = max(self.space_version, space.version)
        metrics.gauge("scenario.space_version", space.version)

    def _entry(self, sid: str):
        """Ledger entry for ``sid`` (the overflow bucket once the cap
        is hit); returns ``(stats, resolved_sid)``. Pure lookup — the
        overflow METRIC is counted once per overflowed row in
        :meth:`observe_rows` only, never here (both observe_rows and
        observe_loss resolve the same rows through this)."""
        st = self._sc.get(sid)
        if st is None:
            if len(self._sc) >= self.max_scenarios:
                sid = OVERFLOW_ID
                st = self._sc.get(sid)
                if st is None:
                    st = self._sc[sid] = _ScenarioStats()
                return st, sid
            st = self._sc[sid] = _ScenarioStats()
        return st, sid

    # -- row accounting --------------------------------------------------------

    def observe_rows(self, stamps, fresh=None) -> int:
        """Account a vector of per-row stamps (dicts or None). ``fresh``
        is a per-row boolean sequence (None = every row is a first use,
        the non-echo path). Returns the number of stamped rows."""
        stamped = fresh_n = echoed_n = overflowed = 0
        with self._lock:
            for i, stamp in enumerate(stamps):
                sid, ver, _ = _stamp_parts(stamp)
                if sid is None:
                    continue
                stamped += 1
                st, resolved = self._entry(sid)
                if resolved != sid:
                    overflowed += 1
                st.rows += 1
                is_fresh = True if fresh is None else bool(fresh[i])
                if is_fresh:
                    st.fresh += 1
                    fresh_n += 1
                else:
                    st.echoed += 1
                    echoed_n += 1
                if ver is not None:
                    # stale-version frames land under the version that
                    # PRODUCED them, not the current one
                    st.versions[ver] = st.versions.get(ver, 0) + 1
        if stamped:
            metrics.count("scenario.rows", stamped)
            if fresh is None:
                metrics.count("scenario.fresh", stamped)
            else:
                metrics.count("scenario.fresh", fresh_n)
                metrics.count("scenario.echoed", echoed_n)
        if overflowed:
            metrics.count("scenario.overflow_rows", overflowed)
        unstamped = len(stamps) - stamped
        if unstamped:
            metrics.count("scenario.unstamped_rows", unstamped)
        return stamped

    def observe_loss(self, stamps, loss) -> None:
        """Attribute one scalar training loss to the scenarios present
        in the batch, weighted by their row counts: each stamped row
        contributes one histogram observation (histogram count == rows
        scored — the exact-histogram contract) and one row of weight to
        the curriculum's windowed per-scenario mean. Theta-stamped rows
        additionally record ``(theta, loss)`` pairs for the
        score-function update."""
        loss = float(loss)
        with self._lock:
            for stamp in stamps:
                sid, _, theta = _stamp_parts(stamp)
                if sid is None:
                    continue
                st, _ = self._entry(sid)
                st.loss.observe(loss)
                st.win_loss_sum += loss
                st.win_rows += 1
                if theta:
                    st.theta.append((list(theta), loss))

    def account_batch(self, batch: dict, loss=None, lead=None) -> int:
        """One-call accounting for a train batch: extract the per-row
        stamps, count rows (echo-drawn batches arrive pre-counted via
        the ``_scenario_rows`` sidecar — only their loss is recorded
        here), and attribute ``loss`` when given. Returns the stamped
        row count (0 when the batch carries no scenario stamps)."""
        if lead is None:
            lead = _batch_lead(batch)
        if not lead:
            return 0
        rows = batch_row_scenarios(batch, lead)
        if rows is None:
            return 0
        pre_counted = SCENARIO_ROWS_KEY in batch
        n = 0
        if not pre_counted:
            n = self.observe_rows(rows)
        else:
            n = sum(1 for r in rows if isinstance(r, dict))
        if loss is not None:
            self.observe_loss(rows, loss)
        return n

    # -- curriculum consumption ------------------------------------------------

    def window_losses(self, reset: bool = True, min_rows: int = 1) -> dict:
        """``{sid: (mean_loss, rows)}`` accumulated since the last
        consume — the curriculum's evidence window. Scenarios with
        fewer than ``min_rows`` scored rows are neither returned NOR
        reset: a floored low-weight scenario keeps accumulating across
        windows until it has enough evidence, so weight adaptation can
        always reverse (discarding sub-threshold windows would freeze a
        starved scenario out of every future update)."""
        out = {}
        with self._lock:
            for sid, st in self._sc.items():
                if st.win_rows >= max(1, min_rows):
                    out[sid] = (st.win_loss_sum / st.win_rows, st.win_rows)
                    if reset:
                        st.win_loss_sum = 0.0
                        st.win_rows = 0
        return out

    def theta_samples(self, sid: str, drain: bool = True) -> list:
        """Recorded ``(theta, loss)`` pairs for one scenario (drained by
        default so each curriculum update sees fresh evidence)."""
        with self._lock:
            st = self._sc.get(str(sid))
            if st is None:
                return []
            out = list(st.theta)
            if drain:
                st.theta.clear()
            return out

    # -- snapshots -------------------------------------------------------------

    def totals(self) -> dict:
        """``{sid: (fresh, echoed)}`` — the exactness check's view."""
        with self._lock:
            return {
                sid: (st.fresh, st.echoed) for sid, st in self._sc.items()
                if st.rows
            }

    def report(self) -> dict:
        with self._lock:
            scenarios = {}
            for sid, st in self._sc.items():
                if not st.rows and not st.loss.count:
                    continue
                scenarios[sid] = {
                    "rows": st.rows,
                    "fresh": st.fresh,
                    "echoed": st.echoed,
                    "declared": sid in self._declared,
                    "versions": dict(sorted(st.versions.items())),
                    "loss": st.loss.summary(),
                }
            return {
                "space_version": self.space_version,
                "declared": sorted(self._declared),
                "scenarios": scenarios,
            }

    def reset(self) -> None:
        """Drop all ledger state (bench measured-window resets); the
        declared-name set survives — the space didn't change."""
        with self._lock:
            declared = self._declared
            self._sc = {sid: _ScenarioStats() for sid in declared}

    # -- session snapshot (blendjax_torch.checkpoint) -------------------------

    def state_dict(self) -> dict:
        """The full ledger for the session store: per-scenario exact
        counts, per-version attribution, the curriculum's evidence
        window (win_loss_sum/win_rows) and bounded theta ring, and the
        exact loss histograms — so a resumed curriculum update sees
        the same evidence the uninterrupted run would have."""
        with self._lock:
            return {
                "space_version": self.space_version,
                "declared": sorted(self._declared),
                "scenarios": {
                    sid: {
                        "rows": st.rows,
                        "fresh": st.fresh,
                        "echoed": st.echoed,
                        "win_loss_sum": st.win_loss_sum,
                        "win_rows": st.win_rows,
                        "theta": [
                            [list(t), float(l)] for t, l in st.theta
                        ],
                        "versions": {
                            int(k): int(v) for k, v in st.versions.items()
                        },
                        "loss": st.loss.state_dict(),
                    }
                    for sid, st in self._sc.items()
                },
            }

    def load_state_dict(self, d: dict) -> None:
        with self._lock:
            self._declared = {str(s) for s in d.get("declared", [])}
            self.space_version = int(d.get("space_version", 0))
            self._sc = {}
            for sid, e in d.get("scenarios", {}).items():
                st = _ScenarioStats()
                st.rows = int(e["rows"])
                st.fresh = int(e["fresh"])
                st.echoed = int(e["echoed"])
                st.win_loss_sum = float(e["win_loss_sum"])
                st.win_rows = int(e["win_rows"])
                st.theta.extend(
                    (list(t), float(l)) for t, l in e.get("theta", [])
                )
                st.versions = {
                    int(k): int(v)
                    for k, v in e.get("versions", {}).items()
                }
                if "loss" in e:
                    st.loss.load_state_dict(e["loss"])
                self._sc[str(sid)] = st
        metrics.gauge("scenario.space_version", self.space_version)


def _batch_lead(batch: dict) -> int:
    meta = batch.get("_meta")
    if isinstance(meta, list) and meta:
        if all(
            isinstance(m, dict) and isinstance(m.get("_meta"), list)
            for m in meta
        ):
            # chunked superbatch: K rest dicts each nesting a per-item
            # list — the row count is their SUM, not K
            return sum(len(m["_meta"]) for m in meta)
        return len(meta)
    rows = batch.get(SCENARIO_ROWS_KEY)
    if rows is not None:
        return len(rows)
    idx = batch.get("_echo_idx")
    if idx is not None:
        return int(idx.shape[0])
    lead = 0
    for k, v in batch.items():
        if not k.startswith("_") and getattr(v, "ndim", 0) >= 1:
            lead = max(lead, int(v.shape[0]))
    return lead


#: Default process-wide ledger (like ``metrics`` and ``lineage``).
accounting = ScenarioAccounting()


__all__ = [
    "SCENARIO_KEY", "SCENARIO_ROWS_KEY", "OVERFLOW_ID",
    "ScenarioAccounting", "accounting", "batch_row_scenarios",
]
