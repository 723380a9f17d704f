"""BJX102 host-sync-in-hot-path: device sync inside the streaming loop.

The streaming modules (``blendjax_torch/data/pipeline.py``,
``blendjax_torch/data/batcher.py``) exist to keep host->card copies
asynchronous and overlapped with the captured step's replays; one stray
``torch.cuda.synchronize()``, ``stream.synchronize()``,
``event.synchronize()`` or ``.item()``, or a fetch or host cast of a
tensor placed on the card, serializes the whole ring. Modules opt in
with a ``bjx: hot-path`` marker comment; the two streaming modules are
always hot by basename.

The vocabulary is :mod:`~blendjax_torch.analysis.rules.driver_sync`'s.
Waits and ``.item()`` are flagged anywhere in a hot module (it has no
sanctioned use for either, as in the JAX rule); ``.tolist()``,
``.cpu()``, ``.numpy()``, ``.to("cpu")`` and the casts only on a name
bound in the same function to a placement on the card (``.to(device)``,
``.cuda()``, a torch factory with a ``device=`` other than ``"cpu"``),
the counterpart of the JAX rule's names bound to ``jax.device_put`` (the
hot modules call ``.tolist()`` on host numpy arrays, where it is no
sync). A pinned host staging buffer (``_pinned_buffer(...)``,
``torch.empty(..., pin_memory=True)``) is never a device value, so
``buf.numpy()[...] = v`` stays clean.
"""

from __future__ import annotations

import ast
from typing import Iterator

from blendjax_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    register,
    walk_shallow,
)
from blendjax_torch.analysis.rules.driver_sync import (
    _is_cpu,
    _names,
    host_names,
    sync_call,
)
from blendjax_torch.analysis.rules.markers import _is_hot

#: method calls that place a tensor on the card
PLACEMENT_METHODS = frozenset({"to", "cuda"})


def _is_placement(value: ast.AST, module: ModuleContext) -> bool:
    """A call whose result lives on the card: ``x.to(dev)`` (not
    ``"cpu"``), ``x.cuda()``, or ``torch.<factory>(..., device=dev)``."""
    if not isinstance(value, ast.Call):
        return False
    func = value.func
    if isinstance(func, ast.Attribute) and func.attr in PLACEMENT_METHODS:
        if func.attr == "cuda":
            return True
        dev = value.args[0] if value.args else next(
            (kw.value for kw in value.keywords if kw.arg == "device"), None)
        return dev is not None and not _is_cpu(dev)
    resolved = module.resolve(func) or ""
    return resolved.startswith("torch.") and any(
        kw.arg == "device" and not _is_cpu(kw.value)
        for kw in value.keywords
    )


@register
class HostSyncRule(Rule):
    id = "BJX102"
    name = "host-sync-in-hot-path"
    description = (
        "blocking device synchronization (synchronize()/.item()/fetch or "
        "host cast of a tensor placed on the card) inside a streaming "
        "hot-path module"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        if not _is_hot(module):
            return
        for qual, fn, _cls in module.iter_functions():
            yield from self._scan(module, fn, qual)

    def _scan(
        self, module: ModuleContext, fn: ast.AST, qual: str
    ) -> Iterator[Finding]:
        # Names bound (anywhere in this function) to a placement on the
        # card: fetching or host-casting those is a card->host round trip.
        placed: set[str] = set()
        for node in walk_shallow(fn):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and _is_placement(node.value, module)
            ):
                placed.add(node.targets[0].id)
        hosts = host_names(fn)

        for node in walk_shallow(fn):
            if not isinstance(node, ast.Call):
                continue
            sync = sync_call(node, module)
            if sync is None:
                continue
            names = _names(sync.target) if sync.target is not None else set()
            if names and names <= hosts:
                continue  # a pinned host buffer
            if sync.kind == "wait":
                yield self.finding(
                    module,
                    node,
                    f"{sync.form} in hot-path '{qual}' stalls the transfer "
                    "ring (prefetch/throttle should bound the queue "
                    "instead)",
                )
            elif sync.form == ".item()":
                yield self.finding(
                    module,
                    node,
                    f"{sync.form} in hot-path '{qual}' forces a card->host "
                    "transfer (keep reductions on the card)",
                )
            else:
                hit = sorted(names & placed)
                if hit:
                    yield self.finding(
                        module,
                        node,
                        f"host fetch {sync.form} of card tensor "
                        f"'{hit[0]}' in hot-path '{qual}' synchronously "
                        "copies the buffer back",
                    )
