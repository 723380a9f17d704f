"""BJX116 host-inflate-in-hot-path: raw zlib inflate on a streaming
hot path.

The zlib "ndz" inflate is the single largest HOST cost of a compressed
wire (BENCH r05's live-vs-step-alone gap decomposition): a decompress
call dropped into a receive/assemble/dispatch loop serializes in front
of the next socket read and is invisible to the wire metrics. The repo
has exactly one sanctioned inflate site — the bounded
``TensorCodec._inflate_bounded`` helper in ``blendjax_torch/transport/wire.py``
(declared-size cap, truncation check, ``wire.inflate_ms`` accounting),
which the sharded ingest pool parallelizes through its shared executor
and which the run-length "ndr" kind bypasses entirely (device-side
expansion inside the train jit). ``wire.py`` itself carries no hot-path
marker, so the codec implementation stays clean by construction.

This rule flags direct ``zlib.decompress(...)`` / ``zlib.decompressobj()``
calls (including ``from zlib import decompress`` aliases) in hot-path
(BJX102 set) and driver-hot-path (BJX106 set) modules: route the bytes
through ``blendjax_torch.transport.wire.decode_message`` (optionally with an
``inflate_pool``) instead, or keep the payload run-packed and expand it
on device (``blendjax_torch.ops.tiles.rle_expand_packed``).
"""

from __future__ import annotations

import ast
from typing import Iterator

from blendjax_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    register,
)
from blendjax_torch.analysis.rules.markers import _is_driver_hot, _is_hot

INFLATE_CALLS = {"zlib.decompress", "zlib.decompressobj"}


@register
class HostInflateRule(Rule):
    id = "BJX116"
    name = "host-inflate-in-hot-path"
    description = (
        "raw zlib inflate (decompress/decompressobj) in a hot-path/"
        "driver-hot-path module, outside the sanctioned wire codec + "
        "shared inflate pool"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        if not (_is_hot(module) or _is_driver_hot(module)):
            return
        for qual, fn, _cls in module.iter_functions():
            yield from self._scan(module, fn, qual)

    def _scan(
        self, module: ModuleContext, fn: ast.AST, qual: str
    ) -> Iterator[Finding]:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            resolved = module.resolve(node.func) or ""
            if resolved in INFLATE_CALLS:
                yield self.finding(
                    module,
                    node,
                    f"host zlib inflate in hot path '{qual}': "
                    f"{resolved}() serializes in front of the next "
                    "recv and bypasses the bounded-size guards + "
                    "wire.inflate_ms accounting of the sanctioned "
                    "codec path — decode through blendjax_torch.transport."
                    "wire.decode_message (with the shared inflate "
                    "pool), or defer run-packed 'ndr' payloads to the "
                    "device plan",
                )
