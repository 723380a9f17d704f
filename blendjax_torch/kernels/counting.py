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
"""

from __future__ import annotations

import contextlib

import torch

_tallies: dict = {}  # CUDA stream handle -> tally of launches queued there


def count_launch(wrapper, variant: str | None = None,
                 work=None) -> None:
    tally = None
    if _tallies:
        tally = _tallies.get(torch.cuda.current_stream().cuda_stream)
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


@contextlib.contextmanager
def diverted(stream):
    """Count the launches queued on ``stream`` (a ``torch.cuda.Stream``)
    into the yielded tally, ``{"launches": {name: n}, "variants": {name:
    {variant: n}}}`` and, once a launch declared its work, ``"work":
    {name: (flops, bytes)}``, not into the wrappers."""
    tally = {"launches": {}, "variants": {}}
    key = stream.cuda_stream
    if key in _tallies:
        raise RuntimeError("launches on this stream are already diverted")
    _tallies[key] = tally
    try:
        yield tally
    finally:
        del _tallies[key]
