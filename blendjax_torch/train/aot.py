"""One CUDA graph per batch signature (port of ``blendjax/train/aot.py``).

The JAX package compiles its step once per batch signature before step 0
(``jit(...).lower(...).compile()``) and dispatches one executable per
call. The port's counterpart is a ``torch.cuda.CUDAGraph`` per signature:
one capture of everything the eager step launches (the decode kernels K1
or K2, the model with the flash kernels K4a-c, the loss, a capturable
AdamW), replayed with one launch per step call.

- :func:`build_aot_step` captures the supervised step for every shape of
  the ``pad_to_bucket`` ladder before step 0 (:func:`batch_specs_for_ladder`)
  and returns an :class:`AotStepSet`; a batch outside the set runs the
  eager step and counts ``aot_fallbacks``, as the JAX set falls back to
  jit.
- :class:`CapturedStep` wraps the fused tile step and the echo step: their
  signature includes the packed group's static host plan (``_spec``,
  ``_names``, ``_geoms``, ``_rle``, ``_pal``), the counterpart of jit's
  cache keyed on static arguments, so each new plan is captured the first
  time it is seen and replayed on that same batch.

A graph reads its inputs from static buffers: each call copies the
batch's tensors into them on the current stream (host arrays, such as an
echo draw's indices, go through a small ring of pinned buffers), seeds the
step's random generators on the host (``step.reseed``; the generators are
registered with the graph, whose replay reads their seed and offset
afresh), replays, advances ``state.step`` by the updates the graph makes,
adds the kernel launches it captured to the wrappers' counts
(:func:`blendjax_torch.kernels.add_launches`) and returns a clone of the
static loss (the driver keeps losses alive across later replays).

Capture needs warm-up calls, which update the weights and the optimizer:
the model's and the optimizer's tensors are snapshotted first and copied
back into the same tensors after the capture, so the first real step
starts from exactly the state the caller passed (an optimizer entry made
during warm-up is zeroed, which is how torch's Adam family starts one).
Neither the warm-up nor the capture counts as a step or as kernel
launches. Each new graph is registered with the device ledger
(:data:`blendjax_torch.obs.devledger.ledger`, ``ledger_entries``): the
kernels' declared work comes from the capture's tally, and the torch
operators' FLOPs from one count
(:func:`blendjax_torch.obs.devledger.count_flops`) over the second
warm-up call of a builder's first capture, scaled by images for its later
signatures (they differ in batch or group size, not in frame shape, and
the matrix products ``FlopCounterMode`` counts are linear in the images).
Capture time is the ``train.compile_ms`` span. A
capture or a replay that fails raises: there is no quiet
fallback to the eager step. On a CPU state nothing is captured and every
call is the eager step; the ladder and the manifest still run.

The persistent cache: the port's compiled code is its ``nvcc`` and
``g++`` output, so :func:`configure_compilation_cache` points the build
directories there, and a keyed manifest (:func:`cache_key`) records the
signatures captured under each key. A signature is warm when the manifest
has it under the key and (on the card) every kernel library is already
built in that directory.
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from blendjax_torch.constants import LOGGER_NAME
from blendjax_torch.data.batcher import bucket_sizes
from blendjax_torch.obs.devledger import count_flops, ledger
from blendjax_torch.train.steps import batch_images, state_device
from blendjax_torch.utils.metrics import metrics

logger = logging.getLogger(f"{LOGGER_NAME}.train")

__all__ = [
    "AotStepSet",
    "CapturedStep",
    "batch_specs_for_ladder",
    "build_aot_step",
    "cache_key",
    "configure_compilation_cache",
]

_MANIFEST = "aot_manifest.json"
# calls of a step before its capture: the first makes the optimizer's
# state and loads every kernel library, the second runs as the capture
# will (the optimizer's state present)
_WARMUP = 2
# host sidecars that never enter a graph: the draw counter reaches the
# graph through the generators' seeds, ``_meta`` is host bookkeeping
_UNKEYED = ("_meta", "_echo_counter")
# the echo ring is read in place: its storage never moves, and a copy of
# it per call would move the whole ring
_BY_REFERENCE = ("_echo_buffers",)


# -- persistent cache wiring --------------------------------------------------

def configure_compilation_cache(cache_dir: str) -> None:
    """Build the port's kernel libraries (``nvcc``) and host C++ (``g++``)
    under ``cache_dir`` from now on, in place of the checkout's
    ``build/``."""
    from blendjax_torch._native import build as native_build
    from blendjax_torch.kernels import build as kernel_build

    os.makedirs(cache_dir, exist_ok=True)
    kernel_build.BUILD_DIR = Path(cache_dir) / "blendjax_torch_kernels"
    native_build.BUILD_DIR = Path(cache_dir) / "blendjax_torch_native"


def _device_name() -> str:
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def cache_key(*, model: object = None, precision: object = None,
              mesh: object = None, decode_plan: object = None,
              buckets: tuple | list | None = None, layout: object = None,
              rules: tuple | list | None = None) -> str:
    """Stable manifest key over everything that changes a captured step:
    the model's class, the precision policy, the mesh layout, the named
    layout and its rules, the decode plan, the bucket ladder, the torch
    version and the card's name (the JAX key's JAX version and backend).
    Change any one and the key moves."""
    if model is not None and not isinstance(model, str):
        model = f"{type(model).__module__}.{type(model).__qualname__}"
    parts = {
        "model": model,
        "precision": None if precision is None else str(
            getattr(precision, "name", precision)),
        "mesh": None if mesh is None else str(mesh),
        "layout": None if layout is None else str(
            getattr(layout, "name", layout)),
        "rules": [repr(r) for r in rules] if rules else None,
        "decode_plan": None if decode_plan is None else str(decode_plan),
        "buckets": list(buckets) if buckets is not None else None,
        "torch": torch.__version__,
        "device": _device_name(),
    }
    blob = json.dumps(parts, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


def _load_manifest(cache_dir: str) -> dict:
    try:
        with open(os.path.join(cache_dir, _MANIFEST)) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def _save_manifest(cache_dir: str, manifest: dict) -> None:
    """Atomic write (a temporary file renamed into place), so a reader
    never sees a torn manifest."""
    try:
        os.makedirs(cache_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f, sort_keys=True)
        os.replace(tmp, os.path.join(cache_dir, _MANIFEST))
    except OSError as e:  # the cache is best-effort, never fatal
        logger.warning("could not persist the aot manifest: %s", e)


def _libraries_built() -> bool:
    from blendjax_torch.kernels import build as kernel_build

    return all(kernel_build.library_path(n).exists()
               for n in kernel_build.SOURCES)


# -- signatures and the shape ladder ------------------------------------------

def _is_batch_array(key: str, value) -> bool:
    """The array fields a step consumes: leading-dim tensors plus the
    bucket-padding ``_mask``; every other underscore stamp is host-side."""
    if key == "_mask":
        return True
    return not key.startswith("_") and getattr(value, "ndim", 0) >= 1


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def batch_specs_for_ladder(example_batch: dict,
                           buckets: tuple | list | None = None) -> list:
    """Every batch signature the driver can dispatch, as ``{field:
    (shape, torch dtype)}``: the full batch without ``_mask`` (the steady
    shape) and each ladder size with its f32 ``_mask`` (partial tails
    always carry it, full batches never do). There is no sharding check:
    the mesh waits for the multi-GPU slice."""
    fields = {k: v for k, v in example_batch.items()
              if k != "_mask" and _is_batch_array(k, v)}
    if not fields:
        raise ValueError("example batch has no array fields to capture against")
    lead = next(iter(fields.values())).shape[0]
    ladder = tuple(buckets) if buckets else bucket_sizes(lead)

    def spec(size: int, with_mask: bool) -> dict:
        out = {k: ((int(size), *map(int, v.shape[1:])), _torch_dtype(v.dtype))
               for k, v in fields.items()}
        if with_mask:
            out["_mask"] = ((int(size),), torch.float32)
        return out

    return [spec(lead, False)] + [spec(s, True) for s in ladder]


def _signature(fields: dict) -> tuple:
    """The (name, shape, dtype) triples of a field dict, or of a spec
    from :func:`batch_specs_for_ladder`."""
    out = []
    for k, v in fields.items():
        shape, dtype = v if isinstance(v, tuple) else (v.shape, v.dtype)
        out.append((k, tuple(int(s) for s in shape), str(_torch_dtype(dtype))))
    return tuple(sorted(out))


def _plan_signature(batch: dict) -> tuple:
    """A packed group's or a draw token's signature: each array's shape
    and dtype, each host plan entry by value, the echo ring by its
    storage, and nothing of ``_meta`` or the draw counter."""
    out = []
    for k in sorted(batch):
        v = batch[k]
        if k in _UNKEYED:
            continue
        if k in _BY_REFERENCE:
            out.append((k, tuple((n, t.data_ptr(), tuple(t.shape), str(t.dtype))
                                 for n, t in sorted(v.items()))))
        elif isinstance(v, (torch.Tensor, np.ndarray)):
            out.append((k, tuple(v.shape), str(v.dtype)))
        elif isinstance(v, dict):
            out.append((k, _plan_signature(v)))
        else:
            hash(v)  # a host plan entry keys the graph by value
            out.append((k, v))
    return tuple(out)


# -- static inputs ------------------------------------------------------------

class _HostStager:
    """Host arrays -> device tensors through a ring of pinned buffers per
    shape and dtype, each reused once the copy that last read it is done,
    so a copy never waits for the queued steps."""

    SLOTS = 4

    def __init__(self):
        self._rings: dict = {}

    def copy(self, dst: torch.Tensor, arr) -> None:
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if dst.device.type != "cuda":
            dst.copy_(src)
            return
        ring = self._rings.setdefault((src.shape, src.dtype),
                                      collections.deque())
        if len(ring) < self.SLOTS:
            entry = [torch.empty(src.shape, dtype=src.dtype).pin_memory(),
                     None]
        else:
            entry = ring.popleft()
            entry[1].synchronize()  # the copy out of it has finished
        ring.append(entry)
        entry[0].copy_(src)
        dst.copy_(entry[0], non_blocking=True)
        entry[1] = torch.cuda.Event()
        entry[1].record()


def _make_static(value, device, key: str = ""):
    """The static counterpart of a batch value: tensors and host arrays
    become device tensors of their own, dicts recurse, the echo ring and
    host plan entries pass as they are."""
    if key in _BY_REFERENCE or key in _UNKEYED:
        return value
    if isinstance(value, torch.Tensor):
        return value.detach().to(device, copy=True)
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(value)).to(device)
    if isinstance(value, dict):
        return {k: _make_static(v, device, k) for k, v in value.items()}
    return value


def _load(static: dict, batch: dict, stager: _HostStager) -> int:
    """Copy ``batch`` into ``static`` on the current stream; returns the
    number of copies queued."""
    copies = 0
    for k, dst in static.items():
        if k in _BY_REFERENCE or k in _UNKEYED:
            continue
        src = batch[k]
        if isinstance(dst, dict):
            copies += _load(dst, src, stager)
        elif isinstance(src, np.ndarray):
            stager.copy(dst, src)
            copies += 1
        elif isinstance(dst, torch.Tensor):
            dst.copy_(src, non_blocking=True)
            copies += 1
    return copies


# -- capture ------------------------------------------------------------------

def _state_tensors(state) -> list:
    """The model's parameters and buffers, then every tensor of the
    optimizer's state, as ``(key, tensor)`` in a fixed order."""
    model = state.model
    out = [(("param", i), p) for i, p in enumerate(model.parameters())]
    out += [(("buffer", i), b) for i, b in enumerate(model.buffers())]
    index = {id(p): i for i, p in enumerate(model.parameters())}
    for p, entry in state.optimizer.state.items():
        for name, t in entry.items():
            if isinstance(t, torch.Tensor):
                out.append((("opt", index.get(id(p), id(p)), name), t))
    return out


def _snapshot(state) -> dict:
    return {key: t.detach().clone() for key, t in _state_tensors(state)}


def _restore(state, snap: dict) -> None:
    with torch.no_grad():
        for key, t in _state_tensors(state):
            if key in snap:
                t.copy_(snap[key])
            else:  # made during warm-up: a fresh Adam entry is zeros
                t.zero_()


def _generators(step, state, batch) -> list:
    hook = getattr(step, "generators", None)
    return list(hook(state, batch)) if hook is not None else []


def _reseed(step, state, batch) -> None:
    hook = getattr(step, "reseed", None)
    if hook is not None:
        hook(state, batch)


class _Graph:
    """One captured step: the graph, its static inputs and loss, what one
    replay adds on the host, and what the device ledger reads: ``flops``
    and the kernels' declared ``work`` of one call, the torch operators'
    FLOPs per image (``op_flops_per_image``, handed to a builder's later
    captures), the bytes of the state it updates in place and the
    ``images`` one call trains on."""

    def __init__(self, step, graph, static, loss, updates, launches,
                 variants, generators, stager, flops=None, work=None,
                 state_bytes: int = 0, images: int | None = None,
                 op_flops_per_image: float | None = None):
        self.step = step
        self.graph = graph
        self.static = static
        self.loss = loss
        self.updates = updates
        self.launches = launches
        self.variants = variants
        self.generators = generators
        self.stager = stager
        self.flops = flops
        self.work = work or {}
        self.state_bytes = int(state_bytes)
        self.images = images
        self.op_flops_per_image = op_flops_per_image
        # host launches of the last call: the input copies, two fills per
        # registered generator (the replay writes its seed and offset), the
        # graph launch and the loss clone
        self.host_launches = 0

    def __call__(self, state, batch):
        from blendjax_torch.kernels import add_launches

        copies = _load(self.static, batch, self.stager)
        _reseed(self.step, state, batch)
        self.graph.replay()
        state.step += self.updates
        add_launches(self.launches, self.variants)
        self.host_launches = copies + 2 * len(self.generators) + 2
        return state, {"loss": self.loss.clone()}


def _capture(step, state, batch, stream, mode: str, stager: _HostStager,
             op_flops_per_image: float | None = None) -> _Graph:
    """Warm up ``step`` on ``batch`` (as static buffers) on ``stream``,
    capture one call into a new graph with its own memory pool, and put
    the state back as it was. The launches of the warm-up and of the
    capture are diverted from the wrappers' counts; the capture's tally
    is what each replay adds, and its declared kernel work what the
    ledger adds to the torch operators' FLOPs. Those are
    ``op_flops_per_image`` x images when given, else counted over the
    last warm-up call (:func:`~blendjax_torch.obs.devledger.count_flops`)."""
    from blendjax_torch.kernels.counting import diverted

    device = state_device(state)
    static = _make_static(batch, device)
    images = batch_images(batch)
    snap = _snapshot(state)
    state_bytes = sum(t.numel() * t.element_size()
                      for _k, t in _state_tensors(state))
    step0 = state.step
    try:
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(_WARMUP - 1):
                _reseed(step, state, static)
                with diverted(stream):
                    step(state, static)
            _reseed(step, state, static)
            if op_flops_per_image is None:
                flops, work = count_flops(lambda: step(state, static), device)
                op_flops = flops - sum(f for f, _b in work.values())
                op_flops_per_image = op_flops / max(images, 1)
            else:
                with diverted(stream):
                    step(state, static)
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        generators = _generators(step, state, static)
        for gen in generators:
            graph.register_generator_state(gen)
        steps1 = state.step
        with diverted(stream) as tally, torch.cuda.graph(
                graph, stream=stream, capture_error_mode=mode):
            _, out = step(state, static)
        updates = state.step - steps1
    finally:
        _restore(state, snap)
        state.step = step0
    work = dict(tally.get("work", {}))
    flops = (op_flops_per_image * images
             + sum(f for f, _b in work.values()))
    return _Graph(step, graph, static, out["loss"], updates,
                  tally["launches"], tally["variants"], generators, stager,
                  flops=flops, work=work, state_bytes=state_bytes,
                  images=images, op_flops_per_image=op_flops_per_image)


def pool_bytes(graph, segments: list | None = None) -> int:
    """Bytes the caching allocator holds in ``graph``'s private memory
    pool: its segments in ``segments`` (one ``torch.cuda.memory_snapshot()``,
    taken here when not given; a caller sizing many graphs takes it once)."""
    pool = tuple(graph.graph.pool())
    if segments is None:
        segments = torch.cuda.memory_snapshot()
    return sum(seg["total_size"] for seg in segments
               if tuple(seg.get("segment_pool_id", ())) == pool)


# -- the AOT step set ---------------------------------------------------------

class AotStepSet:
    """Captured graphs per batch signature, the eager step elsewhere.

    ``graphs`` maps each signature to its :class:`_Graph`, or to ``None``
    on a CPU state (a known signature that runs eagerly). A signature
    outside the set runs the eager step and counts ``aot_fallbacks`` (and
    ``train.aot_fallbacks``); a replay that fails raises. ``_cache_size``
    (the graphs and the distinct signatures run eagerly) is what
    :class:`~blendjax_torch.obs.devledger.RetraceAudit` watches;
    ``ledger_entries`` are the graphs' device-ledger entries."""

    def __init__(self, step, graphs: dict, compile_ms: float,
                 cache_hits: int = 0, cache_misses: int = 0,
                 capture_ms: dict | None = None):
        self._step = step
        self._graphs = graphs
        self.compile_ms = compile_ms
        self.cache_hits = cache_hits
        self.cache_misses = cache_misses
        self.capture_ms = capture_ms or {}
        self.aot_fallbacks = 0
        self.graph_replays = 0
        self.host_launches = 0
        self.ledger_entries: list = []
        self._fallback_sigs: set = set()

    @property
    def signatures(self) -> tuple:
        return tuple(self._graphs)

    def _cache_size(self) -> int:
        return len(self._graphs) + len(self._fallback_sigs)

    @staticmethod
    def signature_of(batch) -> tuple:
        return _signature({k: v for k, v in batch.items()
                           if _is_batch_array(k, v)})

    def __call__(self, state, batch):
        fields = {k: v for k, v in batch.items() if _is_batch_array(k, v)}
        sig = _signature(fields)
        if sig not in self._graphs:
            self.aot_fallbacks += 1
            self._fallback_sigs.add(sig)
            metrics.count("train.aot_fallbacks")
            return self._step(state, fields)
        graph = self._graphs[sig]
        if graph is None:
            return self._step(state, fields)
        out = graph(state, fields)
        self.graph_replays += 1
        self.host_launches = graph.host_launches
        return out


def _ladder_batch(example: dict, spec: dict) -> dict:
    """Concrete inputs of one ladder signature: the example batch's first
    rows, with an all-ones ``_mask`` where the signature has one."""
    out = {}
    for k, (shape, dtype) in spec.items():
        if k == "_mask":
            out[k] = torch.ones(shape, dtype=dtype)
            continue
        v = example[k]
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.asarray(v))
        out[k] = v[: shape[0]]
    return out


def build_aot_step(step, state, example_batch: dict, *,
                   buckets: tuple | list | None = None,
                   cache_dir: str | None = None,
                   key: str | None = None,
                   ledger_name: str = "aot_step") -> AotStepSet:
    """Capture ``step`` for every ladder signature before step 0.

    ``state`` is the concrete train state, ``example_batch`` a full-size
    batch dict. With ``cache_dir`` the build directories move there and
    the keyed manifest decides hit or miss per signature. Each capture
    warms up on a side stream and captures in ``"global"`` mode: no other
    thread of the process may make a call that capture forbids while it
    runs, which holds before step 0. Capture times per signature land on
    ``AotStepSet.capture_ms``, the whole build in the ``train.compile_ms``
    span, and every graph in the device ledger under ``ledger_name``."""
    manifest: dict = {}
    seen: set = set()
    if cache_dir:
        configure_compilation_cache(cache_dir)
        manifest = _load_manifest(cache_dir)
        key = key or cache_key()
        seen = set(manifest.get(key, ()))
    device = state_device(state)
    on_card = device.type == "cuda"
    built = on_card and bool(cache_dir) and _libraries_built()
    stream = torch.cuda.Stream(device) if on_card else None
    stager = _HostStager()
    graphs: dict = {}
    capture_ms: dict = {}
    op_flops_per_image = None
    hits = misses = 0
    t0 = time.perf_counter()
    with metrics.span("train.compile_ms"):
        for spec in batch_specs_for_ladder(example_batch, buckets):
            sig = _signature(spec)
            if sig in graphs:
                continue
            sig_hash = hashlib.sha256(repr(sig).encode()).hexdigest()[:16]
            if cache_dir:
                if sig_hash in seen and (built or not on_card):
                    hits += 1
                    metrics.count("train.aot_cache_hits")
                else:
                    misses += 1
                    metrics.count("train.aot_cache_misses")
                    seen.add(sig_hash)
            if not on_card:
                graphs[sig] = None
                continue
            t1 = time.perf_counter()
            graphs[sig] = graph = _capture(
                step, state, _ladder_batch(example_batch, spec), stream,
                "global", stager, op_flops_per_image)
            op_flops_per_image = graph.op_flops_per_image
            capture_ms[sig] = (time.perf_counter() - t1) * 1e3
    compile_ms = (time.perf_counter() - t0) * 1e3
    if cache_dir:
        manifest[key] = sorted(seen)
        _save_manifest(cache_dir, manifest)
    logger.info("aot step set: %d signatures in %.0f ms (%d warm, %d cold)",
                len(graphs), compile_ms, hits, misses)
    step_set = AotStepSet(step, graphs, compile_ms, hits, misses, capture_ms)
    try:
        step_set.ledger_entries = ledger.register_aot_set(ledger_name, graphs)
    except Exception:  # accounting only: never fails a build
        logger.debug("device ledger registration failed", exc_info=True)
    return step_set


# -- the fused and echo steps -------------------------------------------------

class CapturedStep:
    """``step`` (the fused tile step or the echo step) with one CUDA graph
    per :func:`_plan_signature`, captured the first time a signature is
    seen and replayed on that same batch; :meth:`prepare` captures a
    signature ahead of its first call.

    A capture runs in ``"thread_local"`` mode: it happens mid-run, while
    the echo pipeline's drain thread goes on decoding, staging pinned
    buffers and waiting on events, calls that ``"global"`` mode would
    fail. On a CPU state every call is the eager step.

    Each capture is timed in the ``train.compile_ms`` span and registered
    with the device ledger as ``"captured_step"`` (``ledger_entries``);
    ``_cache_size`` (the graphs captured) is what
    :class:`~blendjax_torch.obs.devledger.RetraceAudit` watches."""

    def __init__(self, step):
        self.step = step
        self._graphs: dict = {}
        self._stream = None
        self._stager = _HostStager()
        self._op_flops_per_image = None  # counted on the first capture
        self.capture_ms: dict = {}
        self.aot_fallbacks = 0  # never: a new signature is captured
        self.graph_replays = 0
        self.host_launches = 0
        self.ledger_entries: list = []

    @property
    def signatures(self) -> tuple:
        return tuple(self._graphs)

    def _cache_size(self) -> int:
        return len(self._graphs)

    signature_of = staticmethod(_plan_signature)

    def _graph(self, state, batch, device):
        sig = _plan_signature(batch)
        graph = self._graphs.get(sig)
        if graph is None:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            t0 = time.perf_counter()
            with metrics.span("train.compile_ms"):
                graph = self._graphs[sig] = _capture(
                    self.step, state, batch, self._stream, "thread_local",
                    self._stager, self._op_flops_per_image)
            self._op_flops_per_image = graph.op_flops_per_image
            self.capture_ms[sig] = (time.perf_counter() - t0) * 1e3
            try:
                self.ledger_entries.append(ledger.register(
                    "captured_step", graph, signature=sig,
                    batch_images=graph.images))
            except Exception:  # accounting only
                logger.debug("device ledger registration failed",
                             exc_info=True)
        return graph

    def prepare(self, state, batch) -> None:
        """Capture ``batch``'s signature ahead of its first call, without
        running the step: the state is left as it was (a capture puts it
        back). A no-op on a CPU state or a signature already captured."""
        device = state_device(state)
        if device.type == "cuda":
            self._graph(state, batch, device)

    def __call__(self, state, batch):
        device = state_device(state)
        if device.type != "cuda":
            return self.step(state, batch)
        graph = self._graph(state, batch, device)
        out = graph(state, batch)
        self.graph_replays += 1
        self.host_launches = graph.host_launches
        return out
