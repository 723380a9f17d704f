"""Locate a Blender executable and check its embedded Python (copied from
``blendjax/launcher/finder.py``): search ``PATH`` and extra paths, parse
``blender --version``, and check that the producer's dependencies import
inside Blender's Python.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

from blendjax_torch.utils.logging import get_logger

logger = get_logger("finder")

_VERSION_RE = re.compile(r"Blender\s+(\d+)\.(\d+)", re.IGNORECASE)

# the producer runtime needs zmq inside Blender's Python, and msgpack for
# the tensor codec
_SMOKE_SCRIPT = (
    "import zmq; "
    "import importlib.util as u; "
    "print('BJX-OK', 'msgpack' if u.find_spec('msgpack') else 'pickle-only')"
)


def discover_blender(additional_blender_paths=None, timeout: float = 30.0):
    """Find Blender and return ``{'path', 'major', 'minor', 'codec'}``, or
    ``None`` when it is missing or unusable."""
    path_env = None
    if additional_blender_paths:
        path_env = os.pathsep.join(
            list(additional_blender_paths) + [os.environ.get("PATH", "")]
        )
    exe = shutil.which("blender", path=path_env)
    if exe is None:
        logger.warning("could not find a blender executable on PATH")
        return None
    try:
        out = subprocess.run(
            [exe, "--version"], capture_output=True, text=True, timeout=timeout
        ).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("failed to run '%s --version': %s", exe, e)
        return None
    m = _VERSION_RE.search(out or "")
    if not m:
        logger.warning("could not parse blender version from %r", out[:200])
        return None
    try:
        smoke = subprocess.run(
            [exe, "--background", "--python-use-system-env",
             "--python-expr", _SMOKE_SCRIPT],
            capture_output=True, text=True, timeout=timeout,
        ).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("blender python smoke test failed to run: %s", e)
        return None
    if "BJX-OK" not in (smoke or ""):
        logger.warning(
            "blender found at %s but its Python cannot import zmq; "
            "install the producer's dependencies into Blender's Python", exe
        )
        return None
    return {
        "path": exe,
        "major": int(m.group(1)),
        "minor": int(m.group(2)),
        "codec": "tensor" if "msgpack" in smoke else "pickle",
    }
