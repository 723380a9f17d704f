"""Device ledger: per-graph FLOPs and memory accounting, live HBM gauges
and a retrace audit (the port of ``blendjax/obs/devledger.py``, rebuilt on
the card's own sources).

The JAX package reads XLA's ``cost_analysis()`` and ``memory_analysis()``
of each compiled step. The port's counterparts, per captured CUDA graph
(:mod:`blendjax_torch.train.aot`):

1. **Capture-time accounting** — :meth:`ExecutableLedger.register` takes
   one captured graph: its FLOPs are ``torch.utils.flop_counter.FlopCounterMode``
   over one eager call of the step at that signature (its second warm-up)
   plus the work each hand-written kernel declares per launch
   (:mod:`blendjax_torch.kernels.work`; the kernels launch through
   ``ctypes``, which the counter does not see), gathered through the
   capture's launch tally; argument bytes are the graph's static batch
   buffers and the train state it updates in place, output bytes its loss,
   temp bytes its private memory pool. Collectives are counted from the
   port's own collective wrappers (:mod:`blendjax_torch.parallel.collectives`),
   not parsed from a program: the tally of one call's collectives (a
   captured graph's, recorded at its capture; an eager step's, through
   :meth:`ExecutableLedger.register_collectives`), in result bytes per
   kind (``device.collective.{all_reduce,all_gather,reduce_scatter,
   collective_permute,all_to_all}_bytes``, the JAX package's names) and
   per mesh axis, summed in ``device.collective_bytes``. A step off a mesh
   issues none (0). Registration is wired into
   :func:`~blendjax_torch.train.aot.build_aot_step`, into each new
   signature of :class:`~blendjax_torch.train.aot.CapturedStep` and, through
   ``ledger_entries``, into ``TrainDriver.build(aot=True)``, whose
   ``train.mfu`` then reads the cost-model FLOPs unless ``flops_per_image``
   is passed by hand. It publishes the ``device.*`` gauge family.
2. **Runtime HBM gauges** — :meth:`ExecutableLedger.poll_memory` reads
   ``torch.cuda.mem_get_info`` and ``torch.cuda.memory_stats`` (neither
   synchronises the card nor allocates on it) at each reporter tick into
   ``device.hbm_*``. On a host without CUDA it returns ``None`` and sets
   nothing.
3. **Retrace audit** — :class:`RetraceAudit` watches a captured step's
   signature count per dispatch; growth past the warm-up window (a graph
   captured mid-run, or an eager fallback on a shape outside an AOT set)
   counts ``device.retraces`` with the signature attributed. A signature
   taken ahead by ``CapturedStep.prepare`` is warm, not a retrace.

Failure policy: every extraction is guarded; a failed one records
``"unavailable"`` and counts ``device.ledger_failures``, never raising
into a build or the reporter thread. The module imports torch lazily.
"""

from __future__ import annotations

import logging
import threading

from blendjax_torch.utils.metrics import Metrics, metrics

logger = logging.getLogger(__name__)

__all__ = [
    "COLLECTIVE_KINDS",
    "ExecutableLedger",
    "KNOWN_PEAK_FLOPS",
    "RetraceAudit",
    "batch_signature",
    "default_peak_flops",
    "ledger",
    "measure_model_flops",
]

UNAVAILABLE = "unavailable"

#: Known peak dense bf16 FLOP/s, matched by substring against the card's
#: name (NVIDIA data sheets; first match wins, the specific names first).
#: ``TrainDriver``'s ``train.mfu`` denominator defaults from it.
KNOWN_PEAK_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),  # the SXM part
    ("h200", 989e12),
    ("a100", 312e12),
)

#: Collective kinds of the JAX package's ledger: on one card each is 0.
COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)

#: Per-kind byte gauges, index-aligned with :data:`COLLECTIVE_KINDS`.
COLLECTIVE_METRICS = (
    "device.collective.all_reduce_bytes",
    "device.collective.all_gather_bytes",
    "device.collective.reduce_scatter_bytes",
    "device.collective.collective_permute_bytes",
    "device.collective.all_to_all_bytes",
)

#: Capture-time accounting gauges, index-aligned with :data:`_ENTRY_FIELDS`.
LEDGER_GAUGES = (
    "device.flops_per_step",
    "device.bytes_accessed",
    "device.hbm_peak_bytes",
    "device.temp_bytes",
    "device.argument_bytes",
    "device.output_bytes",
    "device.generated_code_bytes",
    "device.collective_bytes",
)

_ENTRY_FIELDS = (
    "flops",
    "bytes_accessed",
    "hbm_peak_bytes",
    "temp_bytes",
    "argument_bytes",
    "output_bytes",
    "generated_code_bytes",
    "collective_bytes",
)

#: Runtime HBM gauges from :meth:`ExecutableLedger.poll_memory` (absent
#: on a host without CUDA).
HBM_GAUGES = (
    "device.hbm_in_use_bytes",
    "device.hbm_peak_in_use_bytes",
    "device.hbm_limit_bytes",
    "device.hbm_headroom_frac",
)


def batch_signature(batch: dict) -> tuple:
    """Sorted (field, shape, dtype) over a batch's array fields: ``_mask``
    plus every non-underscore leading-dim field (copied from the JAX
    package). Shape reads only."""
    items = []
    for k in sorted(batch):
        v = batch[k]
        if k.startswith("_") and k != "_mask":
            continue
        shape = tuple(getattr(v, "shape", ()) or ())
        if not shape and k != "_mask":
            continue
        items.append((k, shape, str(getattr(v, "dtype", ""))))
    return tuple(items)


def default_peak_flops(device_name: str | None = None) -> float | None:
    """The card's peak dense bf16 FLOP/s from :data:`KNOWN_PEAK_FLOPS`
    (``None`` for an unknown card or no card)."""
    if device_name is None:
        import torch

        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name(0)
    name = device_name.lower()
    return next((peak for sub, peak in KNOWN_PEAK_FLOPS if sub in name), None)


# -- the FLOP count -----------------------------------------------------------

def count_flops(fn, device) -> tuple:
    """``(flops, kernel_work)`` of one call of ``fn()``:
    ``FlopCounterMode``'s count of the torch operators it runs, plus the
    FLOPs the hand-written kernels it launches declare (on the card their
    launches go to a tally, not to the wrappers' counts). ``kernel_work``
    is ``{kernel: (flops, bytes)}``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from blendjax_torch.kernels.counting import diverted

    work: dict = {}
    counter = FlopCounterMode(display=False)
    if device.type == "cuda":
        with diverted(torch.cuda.current_stream(device)) as tally, counter:
            fn()
        work = dict(tally.get("work", {}))
    else:
        with counter:
            fn()
    flops = counter.get_total_flops() + sum(f for f, _b in work.values())
    return float(flops), work


#: Memo for :func:`measure_model_flops`, keyed by (model class, shape,
#: batch, loss, device type).
_FLOPS_MEMO: dict = {}


def measure_model_flops(model=None, loss_fn=None,
                        label: str = "CubeRegressor fwd+bwd",
                        shape=(480, 640), batch: int = 8,
                        memo: bool = True, device=None) -> dict:
    """FLOPs per image of one supervised update, from
    :func:`count_flops` over one eager, unchunked call of
    ``make_supervised_step(loss_fn)`` on a copy of ``model`` (default a
    seeded ``CubeRegressor()``) with a zero batch of ``batch`` RGBA uint8
    frames of ``shape`` and their ``xy`` corners: the hand-fed figure the
    ledger's cost model is held against. On the card unless
    ``device="cpu"``."""
    import copy

    import torch

    from blendjax_torch.device import resolve_device
    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.train.steps import (
        make_supervised_step,
        make_train_state,
    )

    device = resolve_device(device)
    key = (
        type(model).__name__ if model is not None else "CubeRegressor",
        tuple(shape), int(batch),
        getattr(loss_fn, "__name__", None) if loss_fn else None,
        device.type,
    )
    if memo and key in _FLOPS_MEMO:
        return dict(_FLOPS_MEMO[key])
    model = (CubeRegressor().init_params(0) if model is None
             else copy.deepcopy(model))
    state = make_train_state(model, device=device)
    step = make_supervised_step(loss_fn=loss_fn)
    sb = {
        "image": torch.zeros((batch, *shape, 4), dtype=torch.uint8,
                             device=device),
        "xy": torch.zeros((batch, 8, 2), dtype=torch.float32, device=device),
    }
    flops, work = count_flops(lambda: step(state, sb), device)
    peak = default_peak_flops() if device.type == "cuda" else None
    out = {
        "flops_per_image": round(flops / batch),
        "model": label,
        "source": "FlopCounterMode + declared kernel work (unchunked "
                  "eager step)",
        "kernel_flops": sum(f for f, _b in work.values()),
        "chip": (torch.cuda.get_device_name(device) if device.type == "cuda"
                 else "cpu"),
        "peak_flops": peak,
    }
    if memo:
        _FLOPS_MEMO[key] = dict(out)
    return out


# -- the ledger ----------------------------------------------------------------


def _sig_lead(signature) -> int | None:
    """Leading batch dim of an AOT signature (max over the non-mask
    fields' first dims)."""
    leads = []
    for item in signature or ():
        if (isinstance(item, tuple) and len(item) == 3
                and isinstance(item[1], tuple) and item[0] != "_mask"
                and item[1]):
            leads.append(item[1][0])
    return max(leads) if leads else None


def _nbytes(tree) -> int:
    """Bytes of every tensor in a (nested) dict of a graph's statics."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return int(tree.numel() * tree.element_size()) if hasattr(
        tree, "element_size") else 0


def _collectives(tally, mesh=None) -> dict:
    """A ledger entry's ``collectives``: the kinds in the JAX package's
    order, the per-axis bytes (axes of ``mesh``, a folded group under its
    joined name) and the mesh's shape."""
    out = {"total_bytes": 0, "ops": 0,
           "per_kind": {k: 0 for k in COLLECTIVE_KINDS}, "per_axis": {}}
    if tally:
        out["total_bytes"] = int(tally["total_bytes"])
        out["ops"] = int(tally["ops"])
        for k in COLLECTIVE_KINDS:
            out["per_kind"][k] = int(tally["per_kind"].get(k, 0))
        out["per_axis"] = {k: int(v) for k, v in tally["per_axis"].items()}
    if mesh is not None:
        from blendjax_torch.parallel.mesh import mesh_shape

        out["mesh"] = mesh_shape(mesh)
    return out


class ExecutableLedger:
    """Per-signature device accounting plus the runtime HBM poll and the
    retrace event log. One process-wide instance (:data:`ledger`) mirrors
    everything into the ``device.*`` registry family; :meth:`report` is
    the full structured view (a flight bundle's ``device_ledger.json``).
    """

    def __init__(self, registry: Metrics = metrics):
        self.registry = registry
        self._lock = threading.Lock()
        self._entries: list = []
        self._retraces: list = []
        self._memory: dict | None = None
        self._hbm_peak = 0
        self._flight = None
        self._flight_threshold = 3
        self._flight_fired = False

    # -- capture-time registration --------------------------------------------

    def register(self, name: str, captured, signature=None,
                 batch_images: int | None = None,
                 segments: list | None = None, mesh=None) -> dict:
        """Account one captured graph (a :class:`blendjax_torch.train.aot`
        ``_Graph``: its ``flops`` and kernel ``work``, its static inputs,
        loss, state bytes and private pool, sized from ``segments``, a
        ``torch.cuda.memory_snapshot()``, taken anew when not given).
        Every field is guarded; a failure records ``"unavailable"`` and
        counts ``device.ledger_failures``: this never raises into a
        build."""
        entry: dict = {
            "name": name,
            "signature": repr(signature) if signature is not None else None,
            "batch_images": (int(batch_images) if batch_images
                             else _sig_lead(signature)),
        }
        failures = 0
        try:
            entry["flops"] = float(captured.flops)
            work = dict(captured.work or {})
            entry["kernel_flops"] = float(sum(f for f, _b in work.values()))
            entry["kernel_bytes"] = int(sum(b for _f, b in work.values()))
            entry["kernel_work"] = {k: list(v) for k, v in work.items()}
        except Exception:
            entry["flops"] = UNAVAILABLE
            failures += 1
            logger.debug("flop count unavailable for %s", name, exc_info=True)
        # XLA's "bytes accessed" has no counterpart for the torch operators
        entry["bytes_accessed"] = UNAVAILABLE
        entry["generated_code_bytes"] = UNAVAILABLE
        try:
            from blendjax_torch.train.aot import pool_bytes

            arg = _nbytes(captured.static) + int(captured.state_bytes)
            out = _nbytes(captured.loss)
            temp = int(pool_bytes(captured, segments))
            entry.update(
                argument_bytes=arg, output_bytes=out, temp_bytes=temp,
                # the state is updated in place: counted once, as an input
                hbm_peak_bytes=arg + out + temp,
            )
        except Exception:
            for k in ("argument_bytes", "output_bytes", "temp_bytes",
                      "hbm_peak_bytes"):
                entry[k] = UNAVAILABLE
            failures += 1
            logger.debug("memory accounting unavailable for %s", name,
                         exc_info=True)
        entry["collectives"] = _collectives(
            getattr(captured, "collectives", None), mesh)
        if failures:
            self.registry.count("device.ledger_failures", failures)
        with self._lock:
            self._entries.append(entry)
        self._publish(entry)
        return entry

    def register_collectives(self, name: str, tally: dict | None,
                             mesh=None, batch_images: int | None = None
                             ) -> dict:
        """Account the collectives of one eager step call (``tally`` from
        :func:`blendjax_torch.parallel.collectives.recording`) and publish
        the ``device.collective*`` gauges; the entry has no FLOP or memory
        figures."""
        entry = {"name": name, "signature": None,
                 "batch_images": int(batch_images) if batch_images else None,
                 "flops": UNAVAILABLE,
                 "collectives": _collectives(tally, mesh)}
        with self._lock:
            self._entries.append(entry)
        self._publish(entry)
        return entry

    def register_aot_set(self, name: str, graphs: dict) -> list:
        """Register every captured signature of an AOT step set
        (``{signature: _Graph}``; CPU entries of ``None`` are skipped),
        the largest batch last, so the point-in-time ``device.*`` gauges
        show the steady-state signature. One memory snapshot sizes every
        graph's pool."""
        items = sorted(
            ((sig, g) for sig, g in graphs.items() if g is not None),
            key=lambda kv: (_sig_lead(kv[0]) or 0),
        )
        segments = None
        if items:
            try:
                import torch

                segments = torch.cuda.memory_snapshot()
            except Exception:  # each entry then records its own failure
                logger.debug("memory snapshot unavailable", exc_info=True)
        return [self.register(name, g, signature=sig, segments=segments)
                for sig, g in items]

    def _publish(self, entry: dict) -> None:
        """Mirror one entry into the ``device.*`` gauges (last
        registration wins)."""
        g = self.registry.gauge
        col = entry.get("collectives")
        values = dict(entry)
        if isinstance(col, dict):
            values["collective_bytes"] = col["total_bytes"]
        for field, metric in zip(_ENTRY_FIELDS, LEDGER_GAUGES):
            v = values.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                g(metric, v)
        if isinstance(col, dict):
            for kind, metric in zip(COLLECTIVE_KINDS, COLLECTIVE_METRICS):
                g(metric, col["per_kind"].get(kind, 0))

    # -- cost-model MFU hand-off ----------------------------------------------

    def flops_per_image(self, batch_images: int | None = None) -> float | None:
        """Cost-model FLOPs per image from the newest matching entry
        (``batch_images`` picks the signature whose lead matches; without
        it the largest-lead entry wins)."""
        with self._lock:
            entries = [
                e for e in self._entries
                if isinstance(e.get("flops"), float) and e["batch_images"]
            ]
        if not entries:
            return None
        if batch_images:
            match = [e for e in entries if e["batch_images"] == batch_images]
            entries = match or entries
        e = max(entries, key=lambda e: e["batch_images"])
        return e["flops"] / e["batch_images"]

    # -- runtime HBM poll -----------------------------------------------------

    def poll_memory(self, registry: Metrics | None = None) -> dict | None:
        """One memory sample of each visible card, published as gauges:
        in use (``total - free`` from ``torch.cuda.mem_get_info``: every
        allocation on the card, graph pools and the caching allocator's
        reserve included), the peak of that over the polls, the card's
        total as the limit, and the headroom fraction ``free / total``
        (worst card wins). The sample also carries the caching
        allocator's own figures (``allocated_bytes``, ``reserved_bytes``
        from ``torch.cuda.memory_stats``). Neither call synchronises the
        card or allocates on it. Returns ``None`` without CUDA."""
        reg = registry or self.registry
        try:
            import torch

            if not torch.cuda.is_available():
                with self._lock:
                    self._memory = {"supported": False}
                return None
            per_device = []
            for i in range(torch.cuda.device_count()):
                free, total = torch.cuda.mem_get_info(i)
                stats = torch.cuda.memory_stats(i)
                per_device.append({
                    "device": f"cuda:{i}",
                    "bytes_in_use": int(total - free),
                    "bytes_limit": int(total),
                    "allocated_bytes": int(
                        stats.get("allocated_bytes.all.current", 0)),
                    "reserved_bytes": int(
                        stats.get("reserved_bytes.all.current", 0)),
                })
        except Exception:
            logger.debug("memory poll failed", exc_info=True)
            return None
        in_use = max(d["bytes_in_use"] for d in per_device)
        limit = max(d["bytes_limit"] for d in per_device)
        headroom = min(1.0 - d["bytes_in_use"] / d["bytes_limit"]
                       for d in per_device if d["bytes_limit"])
        headroom = round(max(headroom, 0.0), 4)
        with self._lock:
            self._hbm_peak = max(self._hbm_peak, in_use)
            peak = self._hbm_peak
        sample = {
            "supported": True,
            "bytes_in_use": in_use,
            "peak_bytes_in_use": peak,
            "bytes_limit": limit,
            "headroom_frac": headroom,
            "allocated_bytes": max(d["allocated_bytes"] for d in per_device),
            "reserved_bytes": max(d["reserved_bytes"] for d in per_device),
            "devices": per_device,
        }
        in_use_gauge, peak_gauge, limit_gauge, headroom_gauge = HBM_GAUGES
        reg.gauge(in_use_gauge, in_use)
        reg.gauge(peak_gauge, peak)
        reg.gauge(limit_gauge, limit)
        reg.gauge(headroom_gauge, headroom)
        with self._lock:
            self._memory = sample
        return sample

    # -- retrace events -------------------------------------------------------

    def note_retrace(self, signature, count: int = 1,
                     cache_size: int | None = None) -> None:
        """Record ``count`` retraces attributed to ``signature`` (called
        by :class:`RetraceAudit`); mirrors ``device.retraces`` and arms the
        optional flight dump."""
        self.registry.count("device.retraces", count)
        with self._lock:
            self._retraces.append({
                "signature": repr(signature),
                "count": count,
                "cache_size": cache_size,
            })
            total = sum(r["count"] for r in self._retraces)
            flight = self._flight
            fire = (
                flight is not None and not self._flight_fired
                and total >= self._flight_threshold
            )
            if fire:
                self._flight_fired = True
        if fire:
            try:
                flight.dump(
                    reason=f"retrace-storm: {total} retraces "
                    f"(latest signature {signature!r})",
                    registry=self.registry,
                )
            except Exception:
                logger.exception("retrace flight dump failed")

    def attach_flight(self, recorder, threshold: int = 3) -> None:
        """Arm a one-shot flight-recorder dump once ``threshold`` total
        retraces accumulate (``StatsReporter`` wires its recorder here)."""
        with self._lock:
            self._flight = recorder
            self._flight_threshold = max(1, int(threshold))
            self._flight_fired = False

    # -- views ----------------------------------------------------------------

    @property
    def retrace_count(self) -> int:
        with self._lock:
            return sum(r["count"] for r in self._retraces)

    def report(self) -> dict:
        """Per-signature entries, retrace events with attribution, and the
        last memory sample."""
        with self._lock:
            return {
                "entries": [dict(e) for e in self._entries],
                "retraces": {
                    "count": sum(r["count"] for r in self._retraces),
                    "events": [dict(r) for r in self._retraces],
                },
                "memory": dict(self._memory) if self._memory else None,
            }

    def reset(self) -> None:
        """Drop entries, events and the memory peak (the registry's own
        ``device.*`` values are cleared by ``metrics.reset()``)."""
        with self._lock:
            self._entries.clear()
            self._retraces.clear()
            self._memory = None
            self._hbm_peak = 0
            self._flight_fired = False


#: Process-wide ledger (the registry singleton's sibling).
ledger = ExecutableLedger()


class RetraceAudit:
    """Per-dispatch signature-count delta detection.

    ``observe(batch)`` after every dispatch compares the watched step's
    ``_cache_size()`` (:class:`~blendjax_torch.train.aot.CapturedStep`:
    its captured graphs; :class:`~blendjax_torch.train.aot.AotStepSet`: its
    graphs plus the distinct signatures it ran eagerly) against the last
    observation; growth past the ``warmup`` window counts
    ``device.retraces`` on the ledger, attributed to the batch's
    signature as the step keys it (``signature_of``), else
    :func:`batch_signature`. The first ``warmup`` observations only move
    the baseline. Never raises: a step without ``_cache_size`` disables
    the audit (:attr:`active` False).
    """

    def __init__(self, fn, warmup: int = 2,
                 ledger: ExecutableLedger = ledger):
        self._cache_size = getattr(fn, "_cache_size", None)
        self._signature_of = getattr(fn, "signature_of", batch_signature)
        self.active = callable(self._cache_size)
        self.warmup = max(0, int(warmup))
        self.ledger = ledger
        self._observed = 0
        self._last: int | None = None

    @classmethod
    def for_step(cls, fn, warmup: int = 2) -> "RetraceAudit | None":
        audit = cls(fn, warmup=warmup)
        return audit if audit.active else None

    def observe(self, batch) -> bool:
        """True when this dispatch grew the step's signatures past
        warm-up."""
        if not self.active:
            return False
        try:
            size = int(self._cache_size())
        except Exception:
            self.active = False
            logger.debug("retrace audit disabled", exc_info=True)
            return False
        self._observed += 1
        grew = self._last is not None and size > self._last
        delta = size - (self._last or 0)
        self._last = size
        if not grew or self._observed <= self.warmup:
            return False
        try:
            self.ledger.note_retrace(
                self._signature_of(batch), count=delta, cache_size=size,
            )
        except Exception:
            logger.debug("retrace attribution failed", exc_info=True)
        return True
