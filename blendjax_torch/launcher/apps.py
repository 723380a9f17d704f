"""Launcher as a service (copied from ``blendjax/launcher/apps.py``).

    blendjax-torch-launch launch.json --out launch_info.json
    python -m blendjax_torch.launcher.apps launch.json --out launch_info.json

Reads a JSON file of launcher keyword arguments, starts the fleet, writes
its :class:`~blendjax_torch.launcher.LaunchInfo` JSON for another machine
to connect to, and blocks until the producers exit. ``"kind"`` picks the
launcher: ``"blender"`` (the default) or ``"python"``
(:class:`~blendjax_torch.launcher.PythonProducerLauncher`).
"""

from __future__ import annotations

import argparse
import json
import logging
import signal

from blendjax_torch.launcher.launcher import (
    BlenderLauncher,
    PythonProducerLauncher,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        "blendjax-torch-launch",
        description="Launch a fleet of producers from a JSON config.",
    )
    parser.add_argument(
        "config", help="path to JSON file containing launcher arguments"
    )
    parser.add_argument(
        "--out", default="launch_info.json",
        help="where to write LaunchInfo JSON (default: launch_info.json)",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    # the producers run in sessions of their own, so a SIGTERM to this
    # process does not reach them: turn it into an exception, so the
    # launcher's context unwinds and reaps the fleet
    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)

    with open(args.config) as f:
        cfg = json.load(f)
    kind = cfg.pop("kind", "blender")
    cls = {"blender": BlenderLauncher, "python": PythonProducerLauncher}[kind]
    with cls(**cfg) as launcher:
        launcher.launch_info.save_json(args.out)
        print(f"wrote {args.out}; waiting for producers (ctrl-c to stop)")
        try:
            launcher.wait()
        except KeyboardInterrupt:
            pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
