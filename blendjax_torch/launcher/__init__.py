"""Process orchestration (copied from ``blendjax/launcher``): discover,
spawn, monitor and tear down fleets of producer processes, Blender or any
executable that speaks the launch handshake.

Nothing here imports torch: a launcher may run beside the consumer or in
a process of its own (``python -m blendjax_torch.launcher.apps``).
"""

from blendjax_torch.launcher.arguments import parse_launch_args
from blendjax_torch.launcher.finder import discover_blender
from blendjax_torch.launcher.launch_info import LaunchInfo
from blendjax_torch.launcher.launcher import (
    BlenderLauncher,
    ProcessLauncher,
    PythonProducerLauncher,
    kill_all_spawned,
)

__all__ = [
    "BlenderLauncher",
    "LaunchInfo",
    "ProcessLauncher",
    "PythonProducerLauncher",
    "discover_blender",
    "kill_all_spawned",
    "parse_launch_args",
]
