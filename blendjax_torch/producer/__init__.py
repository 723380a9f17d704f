"""Producer side of the port (numpy + zmq only): the cube scene, its
rasterizer and camera, and the tile-delta batch publisher. Run a producer
process with ``python -m blendjax_torch.producer.cube``."""

from blendjax_torch.producer.camera import Camera
from blendjax_torch.producer.sim import CubeScene, Rasterizer
from blendjax_torch.producer.tile_publisher import TileBatchPublisher

__all__ = ["Camera", "CubeScene", "Rasterizer", "TileBatchPublisher"]
