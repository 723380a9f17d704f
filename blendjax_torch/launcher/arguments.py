"""The launcher <-> producer command-line handshake (copied from
``blendjax/launcher/arguments.py``).

The launcher appends ``-- -btid <int> -btseed <int> -btsockets NAME=ADDR
[NAME=ADDR ...] <user args...>`` to the producer's command line; the
producer splits its argv at ``--`` and parses those flags, and gets the
user's flags back as a remainder. The argv is byte for byte the JAX
package's, so either package's launcher starts either package's
producers.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class LaunchArgs:
    """Parsed producer-side handshake."""

    btid: int
    btseed: int
    btsockets: dict = field(default_factory=dict)

    @property
    def instance_id(self) -> int:
        return self.btid

    @property
    def seed(self) -> int:
        return self.btseed

    @property
    def sockets(self) -> dict:
        return self.btsockets


def parse_launch_args(argv: list[str]):
    """Split ``argv`` at ``--`` and parse the handshake flags; returns
    ``(LaunchArgs, remainder)``. The ``-btsockets`` list ends at the first
    token that is not ``NAME=ADDR`` with a zmq endpoint (``://``), so a
    user argument such as ``scene=warehouse.blend`` stays in the
    remainder."""
    if "--" in argv:
        argv = argv[argv.index("--") + 1:]
    btid = btseed = None
    btsockets: dict = {}
    remainder: list[str] = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok == "-btid" and i + 1 < len(argv):
            btid = int(argv[i + 1])
            i += 2
        elif tok == "-btseed" and i + 1 < len(argv):
            btseed = int(argv[i + 1])
            i += 2
        elif tok == "-btsockets":
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                name, sep, addr = argv[i].partition("=")
                if not sep or "://" not in addr:
                    break
                btsockets[name] = addr
                i += 1
        else:
            remainder.append(tok)
            i += 1
    if btid is None or btseed is None:
        raise ValueError(
            f"missing -btid/-btseed in producer argv {argv!r}; was this "
            "process started by a launcher?"
        )
    return LaunchArgs(btid=btid, btseed=btseed, btsockets=btsockets), remainder


def format_launch_args(btid: int, btseed: int, btsockets: dict,
                       extra: list[str] | None = None) -> list[str]:
    """Launcher-side inverse of :func:`parse_launch_args`."""
    argv = ["-btid", str(btid), "-btseed", str(btseed)]
    if btsockets:
        argv.append("-btsockets")
        argv.extend(f"{name}={addr}" for name, addr in btsockets.items())
    if extra:
        argv.extend(str(e) for e in extra)
    return argv
