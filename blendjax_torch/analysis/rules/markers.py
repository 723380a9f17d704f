"""The module-opt-in markers the per-file rules share.

A module is a streaming hot path when its basename is one of the
streaming modules or a comment line carries ``bjx: hot-path``; it is a
driver hot path when it is named ``driver.py`` or a comment line
carries ``bjx: driver-hot-path``. BJX107, BJX109, BJX110 and BJX116
scope themselves by these tests. Only comment lines count: the marker
quoted in a docstring (this module's own, say) must not opt a module
in.
"""

from __future__ import annotations

import os
import re

from blendjax_torch.analysis.core import ModuleContext

HOT_BASENAMES = {"pipeline.py", "batcher.py"}
HOT_MARKER_RE = re.compile(r"^\s*#.*bjx: hot-path", re.MULTILINE)

DRIVER_BASENAMES = {"driver.py"}
DRIVER_MARKER_RE = re.compile(r"^\s*#.*bjx: driver-hot-path", re.MULTILINE)


def _is_hot(module: ModuleContext) -> bool:
    if os.path.basename(module.relpath) in HOT_BASENAMES:
        return True
    return HOT_MARKER_RE.search(module.source[:4096]) is not None


def _is_driver_hot(module: ModuleContext) -> bool:
    if os.path.basename(module.relpath) in DRIVER_BASENAMES:
        return True
    return DRIVER_MARKER_RE.search(module.source[:4096]) is not None
