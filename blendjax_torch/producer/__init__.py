"""Producer side of the port (numpy + zmq only; nothing here imports
torch): the runtime that runs inside renderer processes (copied from
``blendjax/producer``).

- :class:`AnimationController` over an engine (``sim.SimEngine`` headless,
  ``bpy_engine.BpyEngine`` under Blender) with its :class:`Signal` events;
- :class:`DataPublisher`, :class:`TileBatchPublisher` and the duplex
  :class:`DuplexChannel`;
- :class:`BaseEnv` and :class:`RemoteControlledAgent`, the producer half of
  a remote-controlled environment;
- the scenes of :mod:`~blendjax_torch.producer.sim`, the :class:`Camera`,
  and :func:`parse_launch_args` for the launcher's handshake.

The cube producer runs as ``python -m blendjax_torch.producer.cube`` or as
a launcher script (``blendjax_torch/producer/cube.py``).
"""

from blendjax_torch.launcher.arguments import parse_launch_args
from blendjax_torch.producer.animation import AnimationController
from blendjax_torch.producer.camera import Camera
from blendjax_torch.producer.duplex import DuplexChannel
from blendjax_torch.producer.env import BaseEnv, RemoteControlledAgent
from blendjax_torch.producer.publisher import DataPublisher
from blendjax_torch.producer.signal import Signal
from blendjax_torch.producer.sim import CubeScene, Rasterizer
from blendjax_torch.producer.tile_publisher import TileBatchPublisher

__all__ = [
    "AnimationController",
    "BaseEnv",
    "Camera",
    "CubeScene",
    "DataPublisher",
    "DuplexChannel",
    "Rasterizer",
    "RemoteControlledAgent",
    "Signal",
    "TileBatchPublisher",
    "parse_launch_args",
]
