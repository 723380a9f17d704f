"""Emulate the Blender CLI on top of the fake ``bpy``/``gpu`` stubs.

``python -m blendjax_torch.testing.fake_blender`` accepts the argument
shapes the port's launcher and finder produce (reference command shape,
``pkg_pytorch/blendtorch/btt/launcher.py:137-161`` and
``btt/finder.py:44-69``):

- ``--version``                       -> a parseable "Blender X.Y.Z" line
- ``--background``                    -> build the windowless context
  (``find_first_view3d`` fails there, like real Blender)
- ``--python-expr EXPR``              -> exec EXPR (the finder's zmq/msgpack
  smoke test runs in THIS interpreter's env)
- ``[scene.blend] --python SCRIPT -- ARGS`` -> run SCRIPT with the fake
  runtime installed and ``sys.argv`` set Blender-style (full argv, the
  script splits at ``--`` via ``parse_launch_args``)

:func:`write_fake_blender` drops an executable ``blender`` wrapper into a
directory, so ``discover_blender(additional_blender_paths=[dir])`` and the
port's ``BlenderLauncher`` exercise their real subprocess paths against
the stub. The port's copy of ``blendjax/testing/fake_blender.py``; it
imports neither ``torch`` nor the JAX package.
"""

from __future__ import annotations

import os
import runpy
import stat
import sys

VERSION = "3.6.5"


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if "--version" in args:
        print(f"Blender {VERSION} (blendjax_torch fake-bpy stub)")
        return 0
    background = "--background" in args
    expr = script = None
    if "--python-expr" in args:
        expr = args[args.index("--python-expr") + 1]
    if "--python" in args:
        script = args[args.index("--python") + 1]

    from blendjax_torch.testing import fake_bpy

    # A real `blender` launch without a .blend opens the stock startup
    # scene (Cube/Camera/Light) — scene scripts rely on it.
    fake_bpy.install(background=background, default_scene=True)
    if expr is not None:
        exec(compile(expr, "<python-expr>", "exec"), {"__name__": "__main__"})
    if script is not None:
        # Blender hands scripts its FULL argv; producer scripts split at
        # '--' (``blendjax_torch/launcher/arguments.py``).
        sys.argv = ["blender"] + args
        runpy.run_path(script, run_name="__main__")
    return 0


def write_fake_blender(directory: str) -> str:
    """Write an executable ``blender`` wrapper into ``directory`` and
    return its path. The wrapper runs ``python -m
    blendjax_torch.testing.fake_blender`` under this interpreter, with
    the package importable regardless of the caller's install mode."""
    os.makedirs(directory, exist_ok=True)
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    path = os.path.join(directory, "blender")
    with open(path, "w") as f:
        f.write(
            "#!/bin/sh\n"
            f'PYTHONPATH="{pkg_root}${{PYTHONPATH:+:$PYTHONPATH}}" '
            f'exec "{sys.executable}" -m blendjax_torch.testing.fake_blender'
            ' "$@"\n'
        )
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP
             | stat.S_IXOTH)
    return path


if __name__ == "__main__":
    sys.exit(main())
