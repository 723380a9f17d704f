"""Launch counts of the kernel wrappers.

Each wrapper adds one to its ``launches`` (and, for a kernel with
variants, to ``launches_by_variant[variant]``) where it launches its
kernel, through :func:`count_launch`. A launch queued on a stream inside
:func:`diverted` goes to that context's tally instead: the warm-up and
capture of a CUDA graph launch kernels (or record them) that are not
launches of the run, and the graph's replays add the captured tally to
the counts (:func:`blendjax_torch.kernels.add_launches`). The stream, not
the thread, decides: a backward pass runs on autograd's own thread but on
its forward's stream, while the echo pipeline's drain thread decodes on
another stream during a capture and keeps counting into the wrappers.

A wrapper also declares the work of each launch (a callable giving
``(flops, bytes)``, :mod:`blendjax_torch.kernels.work`), called only when
the launch goes to a tally; a tally sums it per kernel under
``"work"``, so a captured graph knows the kernel work one replay does (the
device ledger adds it to what ``FlopCounterMode`` counts).

A host count of calls that a graph holds (a Python-side counter such as
:data:`blendjax_torch.parallel.ulysses.flash_calls`) follows the same rule
through :func:`count_call`: it registers an adder with
:func:`register_counter`, a call inside :func:`diverted` goes to the
tally's ``"calls"``, and each replay adds them back (:func:`add_calls`),
so the count reads the same per step call, eager or replayed.
"""

from __future__ import annotations

import contextlib

import torch

_tallies: dict = {}  # CUDA stream handle -> tally of launches queued there
_counters: dict = {}  # name -> fn(n) adding n to a host count of calls


def _diverted_tally():
    """The tally of the current stream's :func:`diverted` context, if any."""
    if not _tallies:
        return None
    return _tallies.get(torch.cuda.current_stream().cuda_stream)


def count_launch(wrapper, variant: str | None = None,
                 work=None) -> None:
    tally = _diverted_tally()
    if tally is None:
        wrapper.launches += 1
        if variant is not None:
            wrapper.launches_by_variant[variant] += 1
        return
    name = wrapper.__name__
    tally["launches"][name] = tally["launches"].get(name, 0) + 1
    if work is not None:
        done = tally.setdefault("work", {})
        flops, nbytes = done.get(name, (0, 0))
        add_flops, add_bytes = work()
        done[name] = (flops + int(add_flops), nbytes + int(add_bytes))
    if variant is not None:
        by = tally["variants"].setdefault(name, {})
        by[variant] = by.get(variant, 0) + 1


def register_counter(name: str, add) -> None:
    """Count calls under ``name`` with ``add(n)``, which adds ``n`` to the
    host count (see :func:`count_call`)."""
    _counters[name] = add


def count_call(name: str) -> None:
    """One call under ``name``: to its host count, or, on a stream whose
    launches are :func:`diverted`, to that tally's ``"calls"`` (a graph's
    replays add them, :func:`add_calls`)."""
    tally = _diverted_tally()
    if tally is None:
        _counters[name](1)
        return
    calls = tally.setdefault("calls", {})
    calls[name] = calls.get(name, 0) + 1


def add_calls(calls: dict) -> None:
    """Add the calls a CUDA graph captured to their host counts, on each
    replay."""
    for name, n in calls.items():
        _counters[name](n)


@contextlib.contextmanager
def diverted(stream):
    """Count the launches queued on ``stream`` (a ``torch.cuda.Stream``)
    into the yielded tally, ``{"launches": {name: n}, "variants": {name:
    {variant: n}}}`` and, once a launch declared its work, ``"work":
    {name: (flops, bytes)}``, not into the wrappers; once a host count
    was called, ``"calls": {name: n}`` (:func:`count_call`)."""
    tally = {"launches": {}, "variants": {}}
    key = stream.cuda_stream
    if key in _tallies:
        raise RuntimeError("launches on this stream are already diverted")
    _tallies[key] = tally
    try:
        yield tally
    finally:
        del _tallies[key]
