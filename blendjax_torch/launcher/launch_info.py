"""Serializable record of a launch (copied from
``blendjax/launcher/launch_info.py``): the socket addresses, spawn
commands and process ids of a running fleet, saved as JSON on one machine
and loaded on another to connect a consumer. The JSON is the JAX
package's, so either package reads the other's file.
"""

from __future__ import annotations

import json
import os
from contextlib import nullcontext
from dataclasses import dataclass, field


@dataclass
class LaunchInfo:
    """Addresses (``{socket_name: [addr_per_instance]}``), the spawn
    commands, and the process ids of a launched fleet."""

    addresses: dict
    commands: list = field(default_factory=list)
    processes: list = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(
            {
                "addresses": self.addresses,
                "commands": self.commands,
                "processes": self.processes,
            },
            indent=2,
        )

    def save_json(self, file) -> None:
        """Write to a path (atomically: a temporary file, then
        ``os.replace``, since the other machine polls for the file and
        reads it as soon as it appears) or to an open file object."""
        if isinstance(file, (str, bytes)) or hasattr(file, "__fspath__"):
            path = os.fsdecode(file)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(self.to_json())
            os.replace(tmp, path)
            return
        file.write(self.to_json())

    @staticmethod
    def from_json(text: str) -> "LaunchInfo":
        d = json.loads(text)
        return LaunchInfo(
            addresses=d["addresses"],
            commands=d.get("commands", []),
            processes=d.get("processes", []),
        )

    @staticmethod
    def load_json(file) -> "LaunchInfo":
        ctx = open(file, "r") if isinstance(file, (str, bytes)) or hasattr(
            file, "__fspath__"
        ) else nullcontext(file)
        with ctx as f:
            return LaunchInfo.from_json(f.read())
