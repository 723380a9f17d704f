"""The module-opt-in markers the per-file rules share.

A module is a streaming hot path when its basename is one of the
streaming modules or a comment line carries ``bjx: hot-path``; a driver
hot path when it is named ``driver.py`` or a comment line carries
``bjx: driver-hot-path``; a mesh hot path when it is named
``pipeline.py`` or ``mesh_driver.py`` or a comment line carries
``bjx: mesh-hot-path``; an actor hot path when it is named ``actor.py``
or a comment line carries ``bjx: actor-hot-path``. BJX102, BJX107 and
BJX116 read the first; BJX106, BJX108, BJX109, BJX110, BJX112, BJX114
and BJX125 the second; BJX111 the third; BJX115 the fourth. Only
comment lines count: the marker quoted in a docstring (this module's
own, say) must not opt a module in.
"""

from __future__ import annotations

import os
import re

from blendjax_torch.analysis.core import ModuleContext

HOT_BASENAMES = {"pipeline.py", "batcher.py"}
HOT_MARKER_RE = re.compile(r"^\s*#.*bjx: hot-path", re.MULTILINE)

DRIVER_BASENAMES = {"driver.py"}
DRIVER_MARKER_RE = re.compile(r"^\s*#.*bjx: driver-hot-path", re.MULTILINE)

MESH_HOT_BASENAMES = {"pipeline.py", "mesh_driver.py"}
MESH_MARKER_RE = re.compile(r"^\s*#.*bjx: mesh-hot-path", re.MULTILINE)

ACTOR_BASENAMES = {"actor.py"}
ACTOR_MARKER_RE = re.compile(r"^\s*#.*bjx: actor-hot-path", re.MULTILINE)


def _marked(module: ModuleContext, basenames: set, marker: re.Pattern) -> bool:
    if os.path.basename(module.relpath) in basenames:
        return True
    return marker.search(module.source[:4096]) is not None


def _is_hot(module: ModuleContext) -> bool:
    return _marked(module, HOT_BASENAMES, HOT_MARKER_RE)


def _is_driver_hot(module: ModuleContext) -> bool:
    return _marked(module, DRIVER_BASENAMES, DRIVER_MARKER_RE)


def _is_mesh_hot(module: ModuleContext) -> bool:
    return _marked(module, MESH_HOT_BASENAMES, MESH_MARKER_RE)


def _is_actor_hot(module: ModuleContext) -> bool:
    return _marked(module, ACTOR_BASENAMES, ACTOR_MARKER_RE)
